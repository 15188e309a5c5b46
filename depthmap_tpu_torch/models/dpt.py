"""DPT depth model over a BEiT, ViT or hybrid backbone (NCHW).

Port of ``depthmap_tpu/models/dpt.py`` (ProjectReadout, Reassemble,
DPTDepthModel, build_dpt) in the reference checkpoint layout: the
backbone under ``pretrained.model``, the reassemble stages under
``pretrained.act_postprocess{1..4}`` (indices 0 readout, 3 1x1 proj,
4 resize), the decoder under ``scratch``.  ``with_zoe_taps`` also
returns the taps ZoeDepth's metric head reads.  The hybrid's first two
features are ResNet maps that pass through without a reassemble (its
``act_postprocess1/2`` hold no parameters, so the module has none).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from depthmap_tpu_torch.models.midas_blocks import Scratch


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
    raw disparity, non-negative."""

    def __init__(self, backbone: nn.Module,
                 reassemble_channels: Sequence[int] = (256, 512, 1024, 1024),
                 features: int = 256, with_zoe_taps: bool = False):
        super().__init__()
        self.with_zoe_taps = with_zoe_taps
        self.pretrained = backbone
        dim = backbone.model.cls_token.shape[-1]
        for i, ch in enumerate(reassemble_channels):
            if i >= backbone.spatial_feats:
                setattr(self.pretrained, f"act_postprocess{i + 1}",
                        reassemble(dim, ch, i))
        self.scratch = Scratch(reassemble_channels, features)

    def grid_inputs(self, input_hw: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The forward's keyword inputs for an (H, W) input, computed from
        the parameters alone (the backbone's per-grid hoists)."""
        return self.pretrained.grid_inputs(self.pretrained.grid_for(input_hw),
                                           dtype)

    def head_to_f32(self) -> None:
        """Keep the final 1x1 conv in f32 (call after casting the model to
        a reduced dtype: its weights then hold the rounded values)."""
        self.scratch.head_to_f32()

    def forward(self, x, **grid_inputs):
        """``grid_inputs``: the backbone's (``rel_bias`` for BEiT,
        ``pos_embed`` for ViT), made by the backbone when not given.  With
        ``with_zoe_taps``: (depth, (out_conv_act, r4, p4, p3, p2, p1))."""
        feats, (gh, gw) = self.pretrained(x, **grid_inputs)
        layers = []
        for i, tokens in enumerate(feats):
            if i < self.pretrained.spatial_feats:
                layers.append(tokens)
                continue
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            h = post[0](tokens)
            h = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], gh, gw)
            layers.append(post[3:](h))
        return self.scratch(layers, with_taps=self.with_zoe_taps)


def build_dpt(variant: str) -> DPTDepthModel:
    """variant in {beitl16_512, beitl16_384, vitl16_384, vitb_rn50_384}."""
    from depthmap_tpu_torch.models import beit, vit
    if variant == "beitl16_512":
        return DPTDepthModel(beit.beit_large(512))
    if variant == "beitl16_384":
        return DPTDepthModel(beit.beit_large(384))
    if variant == "vitl16_384":
        return DPTDepthModel(vit.vit_large_384())
    if variant == "vitb_rn50_384":
        return DPTDepthModel(vit.HybridVitBackbone(),
                             reassemble_channels=(256, 512, 768, 768))
    raise ValueError(f"Unknown DPT variant {variant!r}")
