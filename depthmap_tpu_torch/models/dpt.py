"""DPT depth model over a BEiT backbone (NCHW).

Port of ``depthmap_tpu/models/dpt.py`` (ProjectReadout, Reassemble,
DPTDepthModel, build_dpt) in the reference checkpoint layout: the
backbone under ``pretrained.model``, the reassemble stages under
``pretrained.act_postprocess{1..4}`` (indices 0 readout, 3 1x1 proj,
4 resize), the decoder under ``scratch``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.beit import BeitBackbone, beit_large
from depthmap_tpu_torch.models.midas_blocks import Scratch
from depthmap_tpu_torch.ops.resize import scale2x


class ProjectReadout(nn.Module):
    """(B, 1+N, C) tokens -> (B, N, C): concat cls into every token,
    Linear(2C -> C), exact GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        toks = tokens[:, 1:]
        cls = tokens[:, :1].expand_as(toks)
        return self.project(torch.cat([toks, cls], -1))


def reassemble(dim: int, out_ch: int, level: int) -> nn.Sequential:
    """Token sequence -> spatial map at one of 4 scales (level 0: 4x up,
    1: 2x up, 2: identity, 3: 2x down).  Indices 1 and 2 are the
    parameter-free transpose/unflatten of the reference."""
    layers = [ProjectReadout(dim), nn.Identity(), nn.Identity(),
              nn.Conv2d(dim, out_ch, 1)]
    if level == 0:
        layers.append(nn.ConvTranspose2d(out_ch, out_ch, 4, 4))
    elif level == 1:
        layers.append(nn.ConvTranspose2d(out_ch, out_ch, 2, 2))
    elif level == 3:
        layers.append(nn.Conv2d(out_ch, out_ch, 3, 2, 1))
    return nn.Sequential(*layers)


class DPTDepthModel(nn.Module):
    """Backbone -> reassemble -> fusion -> head: (B, 3, H, W) -> (B, H, W)
    raw disparity, non-negative.  The last head conv runs in f32 whatever
    the compute dtype: a bf16 output would quantize the 16-bit depth map to
    ~256 levels."""

    def __init__(self, backbone: BeitBackbone,
                 reassemble_channels: Sequence[int] = (256, 512, 1024, 1024),
                 features: int = 256):
        super().__init__()
        self.pretrained = backbone
        dim = backbone.model.cls_token.shape[-1]
        for i, ch in enumerate(reassemble_channels):
            setattr(self.pretrained, f"act_postprocess{i + 1}",
                    reassemble(dim, ch, i))
        self.scratch = Scratch(reassemble_channels, features)

    def head_to_f32(self) -> None:
        """Keep the final 1x1 conv in f32 (call after casting the model to
        a reduced dtype: its weights then hold the rounded values)."""
        self.scratch.output_conv[4].float()

    def forward(self, x, rel_bias=None):
        feats, (gh, gw) = self.pretrained(x, rel_bias=rel_bias)
        layers = []
        for i, tokens in enumerate(feats):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            h = post[0](tokens)
            h = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], gh, gw)
            layers.append(post[3:](h))
        s = self.scratch
        r1 = s.layer1_rn(layers[0])
        r2 = s.layer2_rn(layers[1])
        r3 = s.layer3_rn(layers[2])
        r4 = s.layer4_rn(layers[3])
        p4 = s.refinenet4(r4, size=r3.shape[2:])
        p3 = s.refinenet3(p4, r3, size=r2.shape[2:])
        p2 = s.refinenet2(p3, r2, size=r1.shape[2:])
        p1 = s.refinenet1(p2, r1)
        out = s.output_conv[0](p1)
        out = scale2x(out, "bilinear", align_corners=True)
        out = F.relu(s.output_conv[2](out))
        head = s.output_conv[4]
        out = F.relu(head(out.to(head.weight.dtype)))
        return out[:, 0]


def build_dpt(variant: str) -> DPTDepthModel:
    """variant in {beitl16_512, beitl16_384}."""
    if variant == "beitl16_512":
        return DPTDepthModel(beit_large(512))
    if variant == "beitl16_384":
        return DPTDepthModel(beit_large(384))
    raise NotImplementedError(
        f"DPT variant {variant!r} is not ported yet (ROADMAP Queue 1 item 8)")
