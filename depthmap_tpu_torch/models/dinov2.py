"""DINOv2 vision transformer backbone (the Depth Anything v1/v2 encoder).

Port of ``depthmap_tpu/models/dinov2.py`` in the reference checkpoint
layout (``cls_token``, ``pos_embed``, ``mask_token``, ``patch_embed.proj``,
``blocks.{i}``, ``norm``):

 * patch 14, training size 518 (a 37 x 37 grid plus cls), pre-norm blocks
   with LayerScale, LayerNorm eps 1e-6;
 * at another grid the position embeddings are resized bicubic through
   torch's ``scale_factor`` path with DINO's +0.1 offset
   (scale = (g + 0.1) / 37, gh on the first spatial axis), no antialias;
 * the final ``norm`` is applied to every tapped block output.

``mask_token`` is a pretraining leftover that inference never reads; it is
kept so a reference checkpoint loads with ``strict=True``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from depthmap_tpu_torch.models.transformer import DinoBlock, PatchEmbed
from depthmap_tpu_torch.ops.resize import interpolate


class DinoV2Backbone(nn.Module):
    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, hooks: Sequence[int] = (4, 11, 17, 23),
                 patch_size: int = 14, train_img_size: int = 518,
                 mlp_ratio: float = 4.0, interpolate_offset: float = 0.1):
        super().__init__()
        self.hooks = tuple(hooks)
        self.depth = depth
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.interpolate_offset = interpolate_offset
        self.grid_n = train_img_size // patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.grid_n ** 2, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.blocks = nn.ModuleList(
            [DinoBlock(embed_dim, num_heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def embed_dim(self) -> int:
        return self.cls_token.shape[-1]

    def pos_embed_for(self, grid: Tuple[int, int],
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The (1, 1 + gh*gw, C) position embeddings at ``grid``, resized
        in f32 and cast to ``dtype`` (default: the parameter's).  They
        depend only on the parameters and the grid: callers compute them
        once per grid."""
        gh, gw = grid
        pos = self.pos_embed
        dtype = dtype or pos.dtype
        if (gh, gw) == (self.grid_n, self.grid_n):
            return pos.to(dtype)
        n, c = self.grid_n, self.embed_dim
        patch = pos[:, 1:].float().reshape(1, n, n, c).permute(0, 3, 1, 2)
        off = self.interpolate_offset
        patch = interpolate(patch, (gh, gw), "bicubic", False,
                            scales=((gh + off) / n, (gw + off) / n))
        patch = patch.permute(0, 2, 3, 1).reshape(1, gh * gw, c)
        return torch.cat([pos[:, :1].float(), patch], 1).to(dtype)

    def grid_inputs(self, grid: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The forward's per-grid keyword inputs: the resized position
        embeddings."""
        return {"pos_embed": self.pos_embed_for(grid, dtype)}

    def forward(self, x, pos_embed: Optional[torch.Tensor] = None):
        """(B, 3, H, W) -> ([normed (B, 1+N, C) tokens at each hook], grid).
        ``pos_embed``: the grid's embeddings from ``pos_embed_for``, made
        here when not given."""
        tokens, grid = self.patch_embed(x)
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        if pos_embed is None:
            pos_embed = self.pos_embed_for(grid, tokens.dtype)
        tokens = torch.cat([cls, tokens], 1) + pos_embed
        feats = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in self.hooks:
                feats.append(self.norm(tokens))
        return feats, grid


DINOV2_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6, hooks=(2, 5, 8, 11)),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, hooks=(2, 5, 8, 11)),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16,
                 hooks=(4, 11, 17, 23)),
    # Depth Anything v1 taps the last four blocks
    "vitl14_da1": dict(embed_dim=1024, depth=24, num_heads=16,
                       hooks=(20, 21, 22, 23)),
}


def build_dinov2(variant: str) -> DinoV2Backbone:
    return DinoV2Backbone(**DINOV2_CONFIGS[variant])
