"""Depth Anything v1 / v2: a DINOv2 encoder and the DPT head (NCHW).

Port of ``depthmap_tpu/models/depth_anything.py`` in the reference
checkpoint layout that ``convert_depth_anything`` reads: the encoder under
``pretrained``, the head under ``depth_head`` with ``projects.{i}`` (1x1),
``resize_layers.{0,1,3}`` (4x and 2x transposed convs, a stride-2 conv;
index 2 is the identity), ``scratch.layer{i}_rn`` (3x3, no bias),
``scratch.refinenet{i}`` (refinenet4 holds a resConfUnit1 it never calls),
``scratch.output_conv1`` and ``scratch.output_conv2.{0,2}``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone, build_dinov2
from depthmap_tpu_torch.models.midas_blocks import FeatureFusionBlockCustom
from depthmap_tpu_torch.ops.resize import interpolate


class _HeadScratch(nn.Module):
    def __init__(self, in_channels: Sequence[int], features: int):
        super().__init__()
        for i, ch in enumerate(in_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, features, 3, 1, 1, bias=False))
            setattr(self, f"refinenet{i + 1}",
                    FeatureFusionBlockCustom(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU(), nn.Identity())


class DPTHeadDA(nn.Module):
    """Tapped patch tokens -> (B, 1, 14 gh, 14 gw) non-negative map.  The
    last conv runs in f32 whatever the compute dtype (``head_to_f32``)."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14):
        super().__init__()
        self.patch_size = patch_size
        self.projects = nn.ModuleList(
            [nn.Conv2d(in_channels, ch, 1) for ch in out_channels])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, 4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, 2, 1)])
        self.scratch = _HeadScratch(out_channels, features)

    def forward(self, feats, grid):
        gh, gw = grid
        layers = []
        for i, tokens in enumerate(feats):
            patch = tokens[:, 1:]
            h = patch.transpose(1, 2).reshape(patch.shape[0], -1, gh, gw)
            layers.append(self.resize_layers[i](self.projects[i](h)))
        s = self.scratch
        r1 = s.layer1_rn(layers[0])
        r2 = s.layer2_rn(layers[1])
        r3 = s.layer3_rn(layers[2])
        r4 = s.layer4_rn(layers[3])
        p4 = s.refinenet4(r4, size=r3.shape[2:])
        p3 = s.refinenet3(p4, r3, size=r2.shape[2:])
        p2 = s.refinenet2(p3, r2, size=r1.shape[2:])
        p1 = s.refinenet1(p2, r1)
        out = s.output_conv1(p1)
        out = interpolate(out, (gh * self.patch_size, gw * self.patch_size),
                          "bilinear", align_corners=True)
        out = F.relu(s.output_conv2[0](out))
        head = s.output_conv2[2]
        return F.relu(head(out.to(head.weight.dtype)))


class DepthAnything(nn.Module):
    """(B, 3, H, W) -> (B, 14 gh, 14 gw) raw disparity, non-negative."""

    def __init__(self, backbone: DinoV2Backbone, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        self.pretrained = backbone
        self.depth_head = DPTHeadDA(backbone.embed_dim, features,
                                    tuple(out_channels), backbone.patch_size)

    def head_to_f32(self) -> None:
        """Keep the final 1x1 conv in f32 (call after casting the model to
        a reduced dtype: its weights then hold the rounded values)."""
        self.depth_head.scratch.output_conv2[2].float()

    def grid_inputs(self, input_hw: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The forward's keyword inputs for an (H, W) input: the encoder's
        resized position embeddings."""
        ps = self.pretrained.patch_size
        return self.pretrained.grid_inputs(
            (input_hw[0] // ps, input_hw[1] // ps), dtype)

    def forward(self, x, pos_embed=None):
        feats, grid = self.pretrained(x, pos_embed=pos_embed)
        out = self.depth_head(feats, grid)
        return F.relu(out)[:, 0]   # the reference applies relu again


_DA2_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
}


def build_depth_anything_v2(variant: str) -> DepthAnything:
    return DepthAnything(build_dinov2(variant), **_DA2_CONFIGS[variant])


def build_depth_anything_v1() -> DepthAnything:
    """depth_anything vitl14: the v2-large head over taps of the last four
    blocks."""
    return DepthAnything(build_dinov2("vitl14_da1"), **_DA2_CONFIGS["vitl"])
