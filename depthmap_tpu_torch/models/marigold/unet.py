"""The SD2 UNet2DConditionModel of Marigold, in torch.

Port of ``depthmap_tpu/models/marigold/unet.py``: an 8-channel latent in
(RGB latent and noisy depth latent), the empty prompt's 1024-wide context;
channels (320, 640, 1280, 1280), three cross-attention down levels and a
plain one, a mid block with cross-attention, the mirrored up path (each
upsample goes to the next skip's size, so odd latents work), heads of 64
and a GEGLU feed-forward with the exact GELU.  GroupNorm eps 1e-5 in the
ResBlocks and ``conv_norm_out``, 1e-6 in each transformer's ``norm``;
LayerNorm eps 1e-5.  Every attention goes to ``models/attention.py``, so to
K1 on the card: a self-attention and a cross-attention (77 keys) in each of
the 16 transformers, 32 launches a forward.  Parameter names follow
diffusers (``down_blocks.{i}.attentions.{j}.transformer_blocks.0.attn2.
to_k``, ``up_blocks.{k}.upsamplers.0.conv``, ``time_embedding.linear_1``,
...), the layout ``depthmap_tpu.models.marigold.convert.convert_unet``
reads.  Each layer computes in flax's promoted dtype (below), so bf16
weights give the JAX package's mixed precision.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.attention import attention


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) f32, cos before sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# flax's dtype promotion, which the JAX package's reduced-precision mode
# relies on: a layer computes in the wider of its input's and its
# parameters' dtypes.  With bf16 weights the UNet so runs in bf16 only up
# to the first ResBlock's time-embedding add (the time embedding is f32),
# and in f32, on the bf16-rounded weights, from there on; the
# cross-attention keys and values of the bf16 context stay bf16.
def _promoted(x: torch.Tensor, *params):
    dt = torch.promote_types(x.dtype, params[0].dtype)
    return (x.to(dt),) + tuple(None if p is None else p.to(dt)
                               for p in params)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_promoted(x, self.weight, self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_promoted(x, self.weight, self.bias))


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _promoted(x, self.weight, self.bias)
        return F.group_norm(x, self.num_groups, w, b, self.eps)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _promoted(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_ch, eps=1e-5)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(32, out_ch, eps=1e-5)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ctx_dim: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx_dim, inner, bias=False)
        self.to_v = Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Identity()])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape

        def heads(t):
            return t.reshape(b, t.shape[1], self.heads, self.dim_head
                             ).transpose(1, 2)
        q, k, v = (self.to_q(x), self.to_k(context), self.to_v(context))
        dt = torch.promote_types(q.dtype, k.dtype)
        o = attention(heads(q.to(dt)), heads(k.to(dt)), heads(v.to(dt)),
                      scale=self.dim_head ** -0.5)
        # JAX's softmax weights take v's dtype, and so does the output
        o = o.to(v.dtype)
        return self.to_out[0](o.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ctx_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, ctx_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                     Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attn1(h, h)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff.net[2](self.ff.net[0](self.norm3(x)))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, dim_head: int, ctx_dim: int):
        super().__init__()
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, ch // dim_head, dim_head, ctx_dim)])
        self.proj_out = Linear(ch, ch)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = self.proj_out(y)
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class _Level(nn.Module):
    """One down or up level: ResBlocks, each followed by its transformer
    where the level has them, then the level's resampler."""

    def __init__(self, resnets, attentions, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _Conv(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=1)


class MarigoldUNet(nn.Module):
    def __init__(self, in_channels: int = 8, out_channels: int = 4,
                 base: int = 320, mults: Sequence[int] = (1, 2, 4, 4),
                 context_dim: int = 1024, dim_head: int = 64):
        super().__init__()
        self.base = base
        temb_ch = base * 4
        self.conv_in = Conv2d(in_channels, base, 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(base, temb_ch)
        self.time_embedding.linear_2 = Linear(temb_ch, temb_ch)
        last = len(mults) - 1
        skips, ch, downs = [base], base, []
        for i, m in enumerate(mults):
            out = base * m
            res, att = [], []
            for _ in range(2):
                res.append(ResBlock(ch, out, temb_ch))
                if i < last:
                    att.append(SpatialTransformer(out, dim_head, context_dim))
                ch = out
                skips.append(ch)
            down = None
            if i < last:
                down = _Conv(ch, 2)
                skips.append(ch)
            downs.append(_Level(res, att, "downsamplers", down))
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResBlock(ch, ch, temb_ch), ResBlock(ch, ch, temb_ch)])
        self.mid_block.attentions = nn.ModuleList(
            [SpatialTransformer(ch, dim_head, context_dim)])
        ups = []
        for i in reversed(range(len(mults))):
            out = base * mults[i]
            res, att = [], []
            for _ in range(3):
                res.append(ResBlock(ch + skips.pop(), out, temb_ch))
                if i < last:
                    att.append(SpatialTransformer(out, dim_head, context_dim))
                ch = out
            ups.append(_Level(res, att, "upsamplers",
                              _Conv(ch, 1) if i > 0 else None))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(32, ch, eps=1e-5)
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """x: (N, 8, H, W); t: (N,) timesteps; context: (N, 77, 1024)."""
        temb = timestep_embedding(t, self.base)
        temb = self.time_embedding.linear_2(
            F.silu(self.time_embedding.linear_1(temb)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                skip = skips.pop()
                dt = torch.promote_types(h.dtype, skip.dtype)
                h = res(torch.cat([h.to(dt), skip.to(dt)], 1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
            if hasattr(blk, "upsamplers"):
                # to the next skip's size (diffusers' upsample_size), JAX's
                # half-pixel "nearest" = torch's nearest-exact
                h = F.interpolate(h, size=tuple(skips[-1].shape[2:]),
                                  mode="nearest-exact")
                h = blk.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
