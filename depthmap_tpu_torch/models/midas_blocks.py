"""MiDaS/DPT decoder blocks (NCHW): scratch projections, residual conv
units, the classic and the custom feature-fusion blocks, and the decoder
they make.

Port of ``depthmap_tpu/models/midas_blocks.py`` (Scratch,
ResidualConvUnitCustom, FeatureFusionBlockCustom, FeatureFusionBlock) in
the reference checkpoint layout (``scratch.layer{i}_rn``,
``scratch.refinenet{i}`` with ``resConfUnit1`` / ``resConfUnit2`` /
``out_conv``, ``scratch.output_conv.{0,2,4}``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.ops.resize import interpolate, scale2x


class ResidualConvUnitCustom(nn.Module):
    """act-conv-act-conv + skip (no BatchNorm: the fusion blocks of the
    ported models run with bn=False).  The classic midas_v21 unit
    (``ResidualConvUnit``) is the same function in the same layout."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        out = self.conv2(F.relu(out))
        return out + x


class FeatureFusionBlockCustom(nn.Module):
    """Optional skip add through resConfUnit1, resConfUnit2, bilinear
    upsample to ``size`` or 2x, then the 1x1 out_conv (halving the
    channels when ``expand``).  ``with_skip`` builds resConfUnit1; the
    forward uses it only when given a skip (Depth Anything's refinenet4
    holds one it never calls, as its checkpoint does)."""

    def __init__(self, features: int, with_skip: bool = True,
                 expand: bool = False, align_corners: bool = True):
        super().__init__()
        self.align_corners = align_corners
        if with_skip:
            self.resConfUnit1 = ResidualConvUnitCustom(features)
        self.resConfUnit2 = ResidualConvUnitCustom(features)
        self.out_conv = nn.Conv2d(features,
                                  features // 2 if expand else features, 1)

    def forward(self, x, skip=None, size: Optional[Tuple[int, int]] = None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if size is None:
            out = scale2x(out, "bilinear", self.align_corners)
        else:
            out = interpolate(out, size, "bilinear", self.align_corners)
        return self.out_conv(out)


class FeatureFusionBlock(nn.Module):
    """The classic block (midas_v21): skip through resConfUnit1,
    resConfUnit2, 2x bilinear (align_corners=True), no out_conv.  Both
    units are built, as in the checkpoint, where refinenet4's first one is
    never called."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnitCustom(features)
        self.resConfUnit2 = ResidualConvUnitCustom(features)

    def forward(self, x, skip=None, size=None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        return scale2x(out, "bilinear", align_corners=True)


class Scratch(nn.Module):
    """3x3 pad-1 bias-free projections of each level (to ``features``, or
    [F, 2F, 4F, 8F] when ``expand``), the four fusion blocks (``classic``
    for midas_v21, else the custom ones, refinenet4 without a skip unit)
    and the output head (``output_conv`` indices 0, 2, 4 as in the
    checkpoint)."""

    def __init__(self, in_channels: Sequence[int], features: int = 256,
                 expand: bool = False, classic: bool = False):
        super().__init__()
        outs = [features * 2 ** i if expand else features for i in range(4)]
        for i, ch in enumerate(in_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, outs[i], 3, 1, 1, bias=False))
            setattr(self, f"refinenet{i + 1}",
                    FeatureFusionBlock(features) if classic else
                    FeatureFusionBlockCustom(outs[i], with_skip=i < 3,
                                             expand=expand and i > 0))
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, 1, 1),
            nn.Identity(),               # Interpolate (parameter-free)
            nn.Conv2d(features // 2, 32, 3, 1, 1),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
        )

    def head_to_f32(self) -> None:
        """Keep the final 1x1 conv in f32 (call after casting the model to
        a reduced dtype: its weights then hold the rounded values)."""
        self.output_conv[4].float()

    def forward(self, layers, fuse_to_size: bool = True,
                head_align_corners: bool = True, with_taps: bool = False):
        """Four level maps -> (B, H, W) non-negative raw map.  DPT fuses
        each level to the next one's size and upsamples the head with
        align_corners=True; the MiDaS v2.1 nets fuse by 2x and upsample the
        head with align_corners=False.  The last conv runs in f32 whatever
        the compute dtype: a bf16 output would quantize the 16-bit depth
        map to ~256 levels.  ``with_taps`` also returns ZoeDepth's taps:
        (the head's post-ReLU 32-channel map, layer4_rn's output, the four
        fusion outputs p4..p1), in the compute dtype."""
        r = [getattr(self, f"layer{i + 1}_rn")(h)
             for i, h in enumerate(layers)]

        def size(j):
            return r[j].shape[2:] if fuse_to_size else None
        p4 = self.refinenet4(r[3], size=size(2))
        p3 = self.refinenet3(p4, r[2], size=size(1))
        p2 = self.refinenet2(p3, r[1], size=size(0))
        p1 = self.refinenet1(p2, r[0])
        out = self.output_conv[0](p1)
        out = scale2x(out, "bilinear", align_corners=head_align_corners)
        out = F.relu(self.output_conv[2](out))
        head = self.output_conv[4]
        depth = F.relu(head(out.to(head.weight.dtype)))[:, 0]
        if with_taps:
            return depth, (out, r[3], p4, p3, p2, p1)
        return depth
