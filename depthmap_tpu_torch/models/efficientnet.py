"""EfficientNet-Lite3 encoder of midas_v21_small (NCHW), with MiDaS's
4-layer taps.

Port of ``depthmap_tpu/models/efficientnet.py`` in the reference
checkpoint layout (timm tf_efficientnet_lite3 split as MiDaS splits it):
``pretrained.layer1`` = conv_stem, bn1, act, blocks[0], blocks[1] at
indices 0-4, ``layer2`` = blocks[2], ``layer3`` = blocks[3:5], ``layer4``
= blocks[5:7]; a depthwise-separable block holds ``conv_dw`` / ``bn1`` /
``conv_pw`` / ``bn2``, an inverted residual ``conv_pw`` / ``bn1`` /
``conv_dw`` / ``bn2`` / ``conv_pwl`` / ``bn3``.  Width 1.2, depth 1.4, no
squeeze-excite, ReLU6, TF SAME padding, BatchNorm eps 1e-3; the depthwise
convs have ``groups = channels``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch.nn as nn

from depthmap_tpu_torch.models.layers import ConvSame, conv_bn_act

BN_EPS = 1e-3


def _round_channels(c: float, divisor: int = 8) -> int:
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


@dataclass(frozen=True)
class BlockCfg:
    kernel: int
    stride: int
    expand: int
    channels: int
    repeats: int


def lite_config(width: float, depth: float) -> Tuple[BlockCfg, ...]:
    """EfficientNet-B0's stage table scaled the Lite way (first and last
    stage repeats fixed, no SE)."""
    base = [  # kernel, stride, expand, channels, repeats
        (3, 1, 1, 16, 1),
        (3, 2, 6, 24, 2),
        (5, 2, 6, 40, 2),
        (3, 2, 6, 80, 3),
        (5, 1, 6, 112, 3),
        (5, 2, 6, 192, 4),
        (3, 1, 6, 320, 1),
    ]
    out = []
    for i, (k, s, e, c, n) in enumerate(base):
        c = _round_channels(c * width)
        if i not in (0, len(base) - 1):
            n = int(math.ceil(n * depth))
        out.append(BlockCfg(k, s, e, c, n))
    return tuple(out)


LITE3 = lite_config(width=1.2, depth=1.4)


class DSConv(nn.Module):
    """Depthwise-separable block (stage 0, expand 1)."""

    def __init__(self, cfg: BlockCfg, in_ch: int, stride: int):
        super().__init__()
        self.conv_dw = ConvSame(in_ch, in_ch, cfg.kernel, stride,
                                groups=in_ch, bias=False)
        self.bn1 = nn.BatchNorm2d(in_ch, eps=BN_EPS)
        self.conv_pw = ConvSame(in_ch, cfg.channels, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cfg.channels, eps=BN_EPS)
        self.residual = stride == 1 and in_ch == cfg.channels

    def forward(self, x):
        h = conv_bn_act(x, self.conv_dw, self.bn1)
        h = conv_bn_act(h, self.conv_pw, self.bn2, act=False)
        return h + x if self.residual else h


class MBConv(nn.Module):
    """Inverted-residual block, Lite flavour (no SE, ReLU6)."""

    def __init__(self, cfg: BlockCfg, in_ch: int, stride: int):
        super().__init__()
        mid = in_ch * cfg.expand
        self.conv_pw = ConvSame(in_ch, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.conv_dw = ConvSame(mid, mid, cfg.kernel, stride, groups=mid,
                                bias=False)
        self.bn2 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.conv_pwl = ConvSame(mid, cfg.channels, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cfg.channels, eps=BN_EPS)
        self.residual = stride == 1 and in_ch == cfg.channels

    def forward(self, x):
        h = conv_bn_act(x, self.conv_pw, self.bn1)
        h = conv_bn_act(h, self.conv_dw, self.bn2)
        h = conv_bn_act(h, self.conv_pwl, self.bn3, act=False)
        return h + x if self.residual else h


class EfficientNetLiteBackbone(nn.Module):
    """Returns the 4 MiDaS feature taps (strides 4, 8, 16, 32; channels
    32, 48, 136, 384 for Lite3)."""

    def __init__(self, cfgs: Tuple[BlockCfg, ...] = LITE3, stem_ch: int = 32):
        super().__init__()
        stages, in_ch = [], stem_ch
        for cfg in cfgs:
            blocks = []
            for b in range(cfg.repeats):
                block = DSConv if cfg.expand == 1 else MBConv
                blocks.append(block(cfg, in_ch, cfg.stride if b == 0 else 1))
                in_ch = cfg.channels
            stages.append(nn.Sequential(*blocks))
        self.layer1 = nn.Sequential(
            ConvSame(3, stem_ch, 3, 2, bias=False),
            nn.BatchNorm2d(stem_ch, eps=BN_EPS), nn.ReLU6(), stages[0],
            stages[1])
        self.layer2 = nn.Sequential(stages[2])
        self.layer3 = nn.Sequential(stages[3], stages[4])
        self.layer4 = nn.Sequential(stages[5], stages[6])

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)
