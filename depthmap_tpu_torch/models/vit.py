"""ViT backbones of MiDaS 3.0 (NCHW): dpt_large_384's ViT-L/16 and
dpt_hybrid_384's ResNetV2-50 + ViT-B/16 hybrid.

Port of ``depthmap_tpu/models/vit.py`` in the reference checkpoint layout
(timm, under ``pretrained.model``): ``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.{i}``; the hybrid's ResNet under
``patch_embed.backbone`` (``stem.conv`` / ``stem.norm``,
``stages.{s}.blocks.{b}.conv{1,2,3}`` / ``norm{1,2,3}`` /
``downsample.{conv,norm}``) and its 1x1 ``patch_embed.proj``.

 * The grid part of the absolute position embedding is resized bilinearly
   (align_corners=False) to the patch grid; it depends only on the
   parameters and the grid, so callers compute it once per grid
   (``grid_inputs``).
 * Features are the block outputs at the hook depths, before the final
   norm.  The hybrid's first two features are its ResNet stage 1-2
   outputs (strides 4 and 8), already spatial.
 * The hybrid's convs are weight-standardized (eps 1e-6) with TF SAME
   zero pads, its stem max-pool TF SAME over -inf pads; tiling mode
   reaches neither, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.layers import MaxPoolPadded, same_pad
from depthmap_tpu_torch.models.transformer import PatchEmbed, VitBlock
from depthmap_tpu_torch.ops.resize import interpolate


def resize_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int,
                     n_prefix: int = 1) -> torch.Tensor:
    """(1, n_prefix + g*g, C) -> (1, n_prefix + gh*gw, C) in f32: the g x g
    grid part resized bilinearly (align_corners=False), the prefix
    tokens as they are."""
    pos = pos_embed.float()
    c = pos.shape[-1]
    g = round((pos.shape[1] - n_prefix) ** 0.5)
    grid = pos[0, n_prefix:].reshape(1, g, g, c).permute(0, 3, 1, 2)
    grid = interpolate(grid, (gh, gw), "bilinear", False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, c)
    return torch.cat([pos[:, :n_prefix], grid], 1)


class VitModel(nn.Module):
    """The timm ViT body as the DPT hooks consume it."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 train_grid: int, patch_embed: nn.Module,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + train_grid ** 2, embed_dim))
        self.patch_embed = patch_embed
        self.blocks = nn.ModuleList(
            [VitBlock(embed_dim, num_heads, mlp_ratio) for _ in range(depth)])


class VitBackbone(nn.Module):
    """Plain ViT with a cls token (vitl16_384): returns the token
    sequences (cls included) at the hook depths, and the grid."""

    spatial_feats = 0     # leading features that are already NCHW maps

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, hooks: Sequence[int] = (5, 11, 17, 23),
                 train_grid: int = 24, patch_size: int = 16,
                 patch_embed: Optional[nn.Module] = None):
        super().__init__()
        self.hooks = tuple(hooks)
        self.depth = depth
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.model = VitModel(embed_dim, depth, num_heads, train_grid,
                              patch_embed or PatchEmbed(embed_dim, patch_size))

    def grid_for(self, input_hw: Tuple[int, int]) -> Tuple[int, int]:
        """The token grid of an (H, W) input."""
        return input_hw[0] // self.patch_size, input_hw[1] // self.patch_size

    def grid_inputs(self, grid: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The forward's per-grid keyword inputs: the position embeddings
        resized in f32 and cast to ``dtype`` (default: the parameter's)."""
        pos = self.model.pos_embed
        return {"pos_embed": resize_pos_embed(pos, *grid).to(
            dtype or pos.dtype)}

    def _blocks(self, tokens, grid, pos_embed):
        if pos_embed is None:
            pos_embed = self.grid_inputs(grid, tokens.dtype)["pos_embed"]
        cls = self.model.cls_token.expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], 1) + pos_embed
        feats = []
        for i, blk in enumerate(self.model.blocks):
            tokens = blk(tokens)
            if i in self.hooks:
                feats.append(tokens)
        return feats

    def forward(self, x, pos_embed: Optional[torch.Tensor] = None):
        """(B, 3, H, W) -> ([(B, 1+N, C) tokens at each hook], grid).
        ``pos_embed``: the grid's embeddings from ``grid_inputs``, made
        here when not given."""
        tokens, grid = self.model.patch_embed(x)
        return self._blocks(tokens, grid, pos_embed), grid


# --- the hybrid's ResNetV2-50 (stem + stages of 3, 4, 9 blocks) ------------

class _StandardizedGrad(torch.autograd.Function):
    """The standardized weight as computed (and cached) without grad, with
    the standardization's gradient to the raw weight: per output channel,
    (g - mean(g) - x_hat * mean(g * x_hat)) / sigma, in f32."""

    @staticmethod
    def forward(ctx, w, std, eps):
        ctx.save_for_backward(w)
        ctx.eps = eps
        return std.clone()

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dims = (1, 2, 3)
        wf, gf = w.float(), g.float()
        mean = wf.mean(dims, keepdim=True)
        inv = torch.rsqrt(wf.var(dims, unbiased=False, keepdim=True)
                          + ctx.eps)
        x_hat = (wf - mean) * inv
        gw = inv * (gf - gf.mean(dims, keepdim=True)
                    - x_hat * (gf * x_hat).mean(dims, keepdim=True))
        return gw.to(w.dtype), None, None


class StdConv(nn.Conv2d):
    """Weight-standardized conv with TF SAME zero pads (timm
    StdConv2dSame, no bias).  The standardized weight depends only on the
    parameter: it is computed in f32 without grad on the first forward
    after the weight changes (a load, an init, a cast, a move or an
    optimizer step) and kept.  With grad enabled and a weight that
    requires it, the forward carries the standardization's gradient to the
    weight (``_StandardizedGrad``); the value is the cached one."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 eps: float = 1e-6):
        super().__init__(in_ch, out_ch, kernel, stride, 0, bias=False)
        self.eps = eps
        self._std_key = None
        self._std = None

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        key = (w._version, w.data_ptr(), w.dtype, w.device)
        if key != self._std_key:
            with torch.no_grad():
                wf = w.float()
                mean = wf.mean((1, 2, 3), keepdim=True)
                var = wf.var((1, 2, 3), unbiased=False, keepdim=True)
                self._std = ((wf - mean) / torch.sqrt(var + self.eps)).to(
                    w.dtype)
            self._std_key = key
        return self._std

    def forward(self, x):
        x = same_pad(x, self.kernel_size[0], self.stride[0])
        std = self.standardized_weight()
        if torch.is_grad_enabled() and self.weight.requires_grad:
            std = _StandardizedGrad.apply(self.weight, std, self.eps)
        return F.conv2d(x, std, None, self.stride)


class GroupNormAct(nn.GroupNorm):
    """GroupNorm (32 groups, eps 1e-5), then ReLU when ``act``."""

    def __init__(self, ch: int, act: bool = True):
        super().__init__(32, ch, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class _ConvNorm(nn.Module):
    """A StdConv and its GroupNorm without activation (``downsample``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv = StdConv(in_ch, out_ch, 1, stride)
        self.norm = GroupNormAct(out_ch, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class ResNetV2Bottleneck(nn.Module):
    """timm ResNetV2's non-pre-activation bottleneck: conv-norm-act x3
    (no act after norm3) plus the shortcut, then ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        mid = out_ch // 4
        self.downsample = _ConvNorm(in_ch, out_ch, stride) if downsample \
            else None
        self.conv1 = StdConv(in_ch, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv(mid, out_ch, 1)
        self.norm3 = GroupNormAct(out_ch, act=False)

    def forward(self, x):
        shortcut = self.downsample(x) if self.downsample is not None else x
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv(3, 64, 7, 2)
        self.norm = GroupNormAct(64)
        self.pool = MaxPoolPadded(3, 2)      # TF SAME over -inf

    def forward(self, x):
        return self.pool(self.norm(self.conv(x)))


class _Stage(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int, stride: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            [ResNetV2Bottleneck(in_ch if b == 0 else out_ch, out_ch,
                                stride if b == 0 else 1, downsample=(b == 0))
             for b in range(n)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class ResNetV2Stages(nn.Module):
    """Stem + 3 stages; returns every stage's output (strides 4, 8, 16;
    256, 512, 1024 channels)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 9)):
        super().__init__()
        self.stem = _Stem()
        chans = [64] + [256 * 2 ** i for i in range(len(layers))]
        self.stages = nn.ModuleList(
            [_Stage(chans[i], chans[i + 1], n, 1 if i == 0 else 2)
             for i, n in enumerate(layers)])

    def forward(self, x):
        h = self.stem(x)
        outs = []
        for stage in self.stages:
            h = stage(h)
            outs.append(h)
        return outs


class HybridPatchEmbed(nn.Module):
    """timm HybridEmbed: the ResNet, then a 1x1 projection of its
    stride-16 output to the embedding width."""

    def __init__(self, embed_dim: int, layers: Tuple[int, ...] = (3, 4, 9)):
        super().__init__()
        self.backbone = ResNetV2Stages(layers)
        self.proj = nn.Conv2d(256 * 2 ** (len(layers) - 1), embed_dim, 1)


class HybridVitBackbone(VitBackbone):
    """vitb_rn50_384: ResNetV2 stages 1-2 as features 1-2, ViT blocks 8
    and 11 as features 3-4; the patch grid is the ResNet's stride-16
    output."""

    spatial_feats = 2

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, hooks: Sequence[int] = (8, 11),
                 train_grid: int = 24, layers: Tuple[int, ...] = (3, 4, 9)):
        super().__init__(embed_dim, depth, num_heads, hooks, train_grid,
                         patch_size=16,
                         patch_embed=HybridPatchEmbed(embed_dim, layers))

    def grid_for(self, input_hw: Tuple[int, int]) -> Tuple[int, int]:
        """Four stride-2 SAME stages (stem conv, max-pool, stages 2 and
        3), each rounding up."""
        h, w = input_hw
        for _ in range(4):
            h, w = -(-h // 2), -(-w // 2)
        return h, w

    def forward(self, x, pos_embed: Optional[torch.Tensor] = None):
        pe = self.model.patch_embed
        s1, s2, feat = pe.backbone(x)
        h = pe.proj(feat)
        grid = (h.shape[2], h.shape[3])
        tokens = h.flatten(2).transpose(1, 2)
        return [s1, s2] + self._blocks(tokens, grid, pos_embed), grid


def vit_large_384() -> VitBackbone:
    return VitBackbone(embed_dim=1024, depth=24, num_heads=16,
                       hooks=(5, 11, 17, 23))
