"""Transformer building blocks of the BEiT and DINOv2 backbones.

Port of ``depthmap_tpu/models/transformer.py`` in the reference checkpoint
layouts.  BEiT (timm): ``patch_embed.proj``, ``blocks.{i}.norm1``,
``attn.qkv`` (no bias), ``attn.q_bias`` / ``attn.k_bias`` (zero, not
trained) / ``attn.v_bias``, ``attn.proj``, ``gamma_1``, ``norm2``,
``mlp.fc1`` / ``mlp.fc2``, ``gamma_2``.  DINOv2: ``attn.qkv`` with a plain
bias, ``ls1.gamma`` / ``ls2.gamma`` for the layer scales, the rest as BEiT.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.attention import attention


class PatchEmbed(nn.Module):
    """Conv patchify: (B, 3, H, W) -> (B, h*w, C) and the grid (h, w)."""

    def __init__(self, embed_dim: int, patch_size: int = 16,
                 in_ch: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, patch_size)

    def forward(self, x) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)
        b, c, h, w = x.shape
        return x.flatten(2).transpose(1, 2), (h, w)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))   # exact (erf) GELU


class BeitAttention(nn.Module):
    """MHSA with BEiT's trainable q/v bias and fixed zero k bias; q/k/v
    leave the packed projection in the (B, H, N, D) layout the kernel
    takes.  ``relative_position_index`` is the train-window index buffer
    of the checkpoint layout; the forward builds each window's bias from
    the table instead (models/beit.py)."""

    def __init__(self, dim: int, num_heads: int,
                 train_window: Tuple[int, int]):
        super().__init__()
        from depthmap_tpu_torch.models.beit import gen_relative_position_index
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("k_bias", torch.zeros(dim))
        twh, tww = train_window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * twh - 1) * (2 * tww - 1) + 3, num_heads))
        self.register_buffer("relative_position_index",
                             gen_relative_position_index(twh, tww))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, bias: Optional[torch.Tensor] = None):
        b, n, c = x.shape
        h = self.num_heads
        qkv_bias = torch.cat([self.q_bias, self.k_bias, self.v_bias])
        qkv = F.linear(x, self.qkv.weight, qkv_bias)
        qkv = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], bias=bias)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (BEiT gamma), LayerNorm
    eps 1e-6."""

    def __init__(self, dim: int, num_heads: int,
                 train_window: Tuple[int, int], mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, train_window)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x, bias: Optional[torch.Tensor] = None):
        x = x + self.gamma_1 * self.attn(self.norm1(x), bias)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class Attention(nn.Module):
    """MHSA with a plain bias on the packed qkv projection (DINOv2), no
    additive attention bias."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return self.gamma * x


class DinoBlock(nn.Module):
    """Pre-norm DINOv2 block: LayerNorm eps 1e-6, LayerScale (``ls1``,
    ``ls2``), exact-GELU MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))
