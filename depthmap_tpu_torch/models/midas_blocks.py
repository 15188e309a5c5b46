"""MiDaS/DPT decoder blocks (NCHW): scratch projections, residual conv
units and the custom feature-fusion blocks.

Port of ``depthmap_tpu/models/midas_blocks.py`` (Scratch,
ResidualConvUnitCustom, FeatureFusionBlockCustom) in the reference
checkpoint layout (``scratch.layer{i}_rn``, ``scratch.refinenet{i}``
with ``resConfUnit1`` / ``resConfUnit2`` / ``out_conv``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.ops.resize import interpolate, scale2x


class ResidualConvUnitCustom(nn.Module):
    """act-conv-act-conv + skip (no BatchNorm: DPT's fusion blocks run
    with bn=False)."""

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
    upsample (align_corners=True) to ``size`` or 2x, then the 1x1
    out_conv."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnitCustom(features)
        self.resConfUnit2 = ResidualConvUnitCustom(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size: Optional[Tuple[int, int]] = None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if size is None:
            out = scale2x(out, "bilinear", align_corners=True)
        else:
            out = interpolate(out, size, "bilinear", align_corners=True)
        return self.out_conv(out)


class Scratch(nn.Module):
    """3x3 pad-1 bias-free projections of each level to ``features``, the
    four fusion blocks and the output head (``output_conv`` indices 0, 2,
    4 as in the checkpoint)."""

    def __init__(self, in_channels: Sequence[int], features: int = 256):
        super().__init__()
        for i, ch in enumerate(in_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, features, 3, 1, 1, bias=False))
        self.refinenet1 = FeatureFusionBlockCustom(features)
        self.refinenet2 = FeatureFusionBlockCustom(features)
        self.refinenet3 = FeatureFusionBlockCustom(features)
        self.refinenet4 = FeatureFusionBlockCustom(features, with_skip=False)
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, 1, 1),
            nn.Identity(),               # Interpolate (parameter-free)
            nn.Conv2d(features // 2, 32, 3, 1, 1),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
        )
