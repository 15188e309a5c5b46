"""The Stable-Diffusion AutoencoderKL (Marigold's VAE) in torch.

Port of ``depthmap_tpu/models/marigold/vae.py``: 128 base channels,
multipliers (1, 2, 4, 4), two ResnetBlocks a level down and three up,
GroupNorm(32, eps 1e-6) + SiLU, a downsample that pads (0, 1) before its
stride-2 convolution, a nearest 2x upsample, and a mid block with one
attention head of width 512.  That attention stays plain torch (K1 takes
D = 64 only); its scores and softmax are f32, as the JAX package computes
them.  Parameter names follow diffusers' AutoencoderKL (``encoder.
down_blocks.{i}.resnets.{j}.conv1``, ``encoder.mid_block.attentions.0.
to_q``, ``quant_conv``, ``decoder.up_blocks.{k}.upsamplers.0.conv``, ...),
the layout ``depthmap_tpu.models.marigold.convert.convert_vae`` reads.
Marigold uses the encoder's mean.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

VAE_SCALE = 0.18215


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """One head over all positions, the scores and softmax in f32."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = _gn(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)       # (n, hw, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = self.to_out[0](torch.matmul(a, v))
        return x + o.transpose(1, 2).reshape(n, c, h, w)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    def __init__(self, resnets, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, "downsamplers" if isinstance(sampler, Downsample)
                    else "upsamplers", nn.ModuleList([sampler]))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch),
                                      ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, base: int = 128, mults: Sequence[int] = (1, 2, 4, 4),
                 latent_ch: int = 4):
        super().__init__()
        self.conv_in = nn.Conv2d(3, base, 3, padding=1)
        blocks, ch = [], base
        for i, m in enumerate(mults):
            out = base * m
            blocks.append(_Level(
                [ResnetBlock(ch, out), ResnetBlock(out, out)],
                Downsample(out) if i < len(mults) - 1 else None))
            ch = out
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Mid(ch)
        self.conv_norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(ch, 2 * latent_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, base: int = 128, mults: Sequence[int] = (1, 2, 4, 4),
                 latent_ch: int = 4):
        super().__init__()
        ch = base * mults[-1]
        self.conv_in = nn.Conv2d(latent_ch, ch, 3, padding=1)
        self.mid_block = _Mid(ch)
        blocks = []
        for i in reversed(range(len(mults))):
            out = base * mults[i]
            blocks.append(_Level(
                [ResnetBlock(ch, out), ResnetBlock(out, out),
                 ResnetBlock(out, out)], Upsample(out) if i > 0 else None))
            ch = out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(ch, 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, base: int = 128, mults: Sequence[int] = (1, 2, 4, 4),
                 latent_ch: int = 4):
        super().__init__()
        self.encoder = Encoder(base, mults, latent_ch)
        self.decoder = Decoder(base, mults, latent_ch)
        self.quant_conv = nn.Conv2d(2 * latent_ch, 2 * latent_ch, 1)
        self.post_quant_conv = nn.Conv2d(latent_ch, latent_ch, 1)
        self.latent_ch = latent_ch

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) in [-1, 1] -> the latent mean (N, 4, H/8, W/8)."""
        return self.quant_conv(self.encoder(x))[:, :self.latent_ch]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
