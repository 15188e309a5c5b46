"""BEiT backbone for MiDaS 3.1 (dpt_beit_large_512 / _384, dpt_beit_base_384).

Port of ``depthmap_tpu/models/beit.py``: no absolute position embedding;
every block adds a relative-position bias to its attention logits, built
from the block's (2Wh-1)(2Ww-1)+3 table.  At a window other than the
training one, the token-token part of the table is bilinearly resized,
laid out width-major as the reference does; the 3 cls rows stay verbatim.

The bias has three tiers, as in the JAX package: all ``depth`` biases
hoisted once per grid under BIAS_HOIST_CAP (``grid_inputs``); above it
each block gathers its own (1, H, N, N) bias inline; and when one block's
bias (H.N^2 in the input's dtype) would exceed DEPTHMAP_BIAS_STREAM_BYTES,
each block hands attention only its resized table (``RelBiasSpec``), and
nothing quadratic is materialized (models/attention.py).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from depthmap_tpu_torch.models.attention import RelBiasSpec, gather_rel_bias
from depthmap_tpu_torch.models.transformer import Block, PatchEmbed
from depthmap_tpu_torch.ops.flash_attention import rel_pos_index
from depthmap_tpu_torch.ops.resize import interpolate

# All `depth` hoisted rel-pos biases stay resident below this many bytes;
# above it each block builds its bias inline (one resident at a time).
BIAS_HOIST_CAP = 2 << 30
# One block's bias above this many bytes streams (the JAX package's
# default of DEPTHMAP_BIAS_STREAM_BYTES)
BIAS_STREAM_BYTES = 256 << 20


def streams_bias(num_heads: int, n: int, dtype: torch.dtype) -> bool:
    """Whether a block's (H, N, N) bias in ``dtype`` is over the stream
    budget, DEPTHMAP_BIAS_STREAM_BYTES read at call time (the JAX
    package's expression: N unpadded, the backbone input's itemsize)."""
    budget = int(os.environ.get("DEPTHMAP_BIAS_STREAM_BYTES",
                                BIAS_STREAM_BYTES))
    return num_heads * n * n * dtype.itemsize > budget


def gen_relative_position_index(wh: int, ww: int, device=None,
                                ld: Optional[int] = None) -> torch.Tensor:
    """(wh*ww+1, ld) int64 index into the bias table in timm's layout
    (``ld`` defaults to wh*ww+1; columns past it index entry 0), built on
    ``device`` by the formula K1's table mode computes
    (``rel_pos_index``)."""
    n = wh * ww + 1
    t = torch.arange(n if ld is None else ld, device=device)
    index = rel_pos_index(t[:n], t.clamp(max=n - 1), (wh, ww))
    index[:, n:] = 0
    return index


def rel_pos_table(table: torch.Tensor, train_window: Tuple[int, int],
                  window: Tuple[int, int],
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(num_rel + 3, H) table at train_window -> the (num_rel' + 3, H)
    table of ``window``, in ``dtype`` (default: the table's); the
    counterpart of ``RelPosBias(table_only=True)``."""
    twh, tww = train_window
    wh, ww = window
    nh = table.shape[1]
    old_num = (2 * twh - 1) * (2 * tww - 1) + 3
    new_h, new_w = 2 * wh - 1, 2 * ww - 1
    if (wh, ww) != (twh, tww):
        # width-major layout (2*tww-1, 2*twh-1, H), then bilinear to
        # (new_h, new_w), as the reference does
        sub = table[:old_num - 3].reshape(2 * tww - 1, 2 * twh - 1, nh)
        sub = interpolate(sub.permute(2, 0, 1)[None], (new_h, new_w),
                          "bilinear", False)
        sub = sub[0].permute(1, 2, 0).reshape(new_h * new_w, nh)
        table = torch.cat([sub, table[old_num - 3:]], 0)
    if dtype is not None:
        # cast the table, not the bias: a cast of the padded view would
        # return a dense copy (a gather is exact, so the values agree)
        table = table.to(dtype)
    return table


def rel_pos_bias(table: torch.Tensor, train_window: Tuple[int, int],
                 window: Tuple[int, int],
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(num_rel + 3, H) table at train_window -> (1, H, N, N) bias for
    ``window`` (N = wh*ww + 1), in ``dtype`` (default: the table's) and on
    the table's device, gathered from ``rel_pos_table``.  The bias is the
    ``[..., :N]`` view of a (1, H, N, bias_row_len(N)) buffer: the
    padded-row layout kernel K1 reads with no copy."""
    table = rel_pos_table(table, train_window, window, dtype)
    n = window[0] * window[1] + 1
    return gather_rel_bias(table, torch.arange(n, device=table.device), n,
                           window)


class BeitModel(nn.Module):
    """The timm BEiT body as the DPT hooks consume it (checkpoint keys
    ``cls_token``, ``patch_embed.proj``, ``blocks.{i}``)."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, train_img_size: int = 512,
                 patch_size: int = 16, mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_size = patch_size
        self.num_heads = num_heads
        tw = train_img_size // patch_size
        self.train_window = (tw, tw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, self.train_window, mlp_ratio)
             for _ in range(depth)])


class BeitBackbone(nn.Module):
    """Returns the token sequences (incl. cls) at the hook depths."""

    spatial_feats = 0     # leading features that are already NCHW maps

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, hooks: Sequence[int] = (5, 11, 17, 23),
                 train_img_size: int = 512, patch_size: int = 16):
        super().__init__()
        self.hooks = tuple(hooks)
        self.depth = depth
        self.model = BeitModel(embed_dim, depth, num_heads, train_img_size,
                               patch_size)

    @property
    def patch_size(self) -> int:
        return self.model.patch_size

    @property
    def num_heads(self) -> int:
        return self.model.num_heads

    def grid_for(self, input_hw: Tuple[int, int]) -> Tuple[int, int]:
        """The token grid of an (H, W) input."""
        return input_hw[0] // self.patch_size, input_hw[1] // self.patch_size

    def block_bias(self, i: int, window: Tuple[int, int],
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        table = self.model.blocks[i].attn.relative_position_bias_table
        return rel_pos_bias(table, self.model.train_window, window, dtype)

    def block_table(self, i: int, window: Tuple[int, int]) -> RelBiasSpec:
        """Block i's streamed bias: its table resized to ``window``."""
        table = self.model.blocks[i].attn.relative_position_bias_table
        return RelBiasSpec(rel_pos_table(table, self.model.train_window,
                                         window), *window)

    def grid_inputs(self, grid: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The forward's per-grid keyword inputs: all ``depth`` biases
        hoisted when they fit under BIAS_HOIST_CAP (the 512² bucket, ~0.8
        GB bf16), else None, and each block builds its own (a 1080p input,
        N = 1793, would need ~2.5 GB)."""
        n = grid[0] * grid[1] + 1
        itemsize = torch.empty((), dtype=dtype or self.model.cls_token.dtype
                               ).element_size()
        if self.depth * self.num_heads * n * n * itemsize > BIAS_HOIST_CAP:
            return {"rel_bias": None}
        return {"rel_bias": precompute_rel_biases(self, grid, dtype)}

    def forward(self, x, rel_bias: Optional[Sequence[torch.Tensor]] = None):
        """rel_bias: optional ``depth`` precomputed (1, H, N, N) biases
        (``precompute_rel_biases``); without it each block builds its bias
        inline, so at most one bias is resident, or, when one block's bias
        in x's dtype is over the stream budget (``streams_bias``), hands
        attention its resized table."""
        tokens, grid = self.model.patch_embed(x)
        cls = self.model.cls_token.expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], 1)
        stream = rel_bias is None and streams_bias(
            self.num_heads, grid[0] * grid[1] + 1, x.dtype)
        feats = []
        for i, blk in enumerate(self.model.blocks):
            if rel_bias is not None:
                bias = rel_bias[i]
            elif stream:
                bias = self.block_table(i, grid)
            else:
                bias = self.block_bias(i, grid)
            tokens = blk(tokens, bias)
            del bias   # an inline bias goes before the next is built
            if i in self.hooks:
                feats.append(tokens)
        return feats, grid


def beit_large(img_size: int, hooks=(5, 11, 17, 23)) -> BeitBackbone:
    return BeitBackbone(embed_dim=1024, depth=24, num_heads=16, hooks=hooks,
                        train_img_size=img_size)


def beit_base(img_size: int = 384, hooks=(2, 5, 8, 11)) -> BeitBackbone:
    return BeitBackbone(embed_dim=768, depth=12, num_heads=12, hooks=hooks,
                        train_img_size=img_size)


@torch.no_grad()
def precompute_rel_biases(backbone: BeitBackbone, window: Tuple[int, int],
                          dtype: Optional[torch.dtype] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """All ``depth`` relative-position biases for one window, computed
    once (they depend only on the parameters and the window)."""
    return tuple(backbone.block_bias(i, window, dtype)
                 for i in range(backbone.depth))
