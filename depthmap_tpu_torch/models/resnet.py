"""ResNeXt101-32x8d encoder of midas_v21 (NCHW), with MiDaS's 4-layer taps.

Port of ``depthmap_tpu/models/resnet.py`` in the reference checkpoint
layout: torchvision's resnext101_32x8d split as MiDaS splits it
(``pretrained.layer1`` = conv1, bn1, relu, maxpool, resnet.layer1 at
indices 0, 1, 2, 3, 4; ``pretrained.layer{2,3,4}``), each bottleneck with
``conv{1,2,3}`` / ``bn{1,2,3}`` / ``downsample.{0,1}``.  BatchNorm eps
1e-5, in eval mode.  The stem max-pool pads with -inf explicitly, so
tiling mode (which reaches the padded convs) leaves it as the JAX package
does.
"""
from __future__ import annotations

from typing import Tuple

import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.layers import MaxPoolPadded


class Bottleneck(nn.Module):
    """Grouped bottleneck: 1x1, 3x3 (groups, stride), 1x1 x4, each with
    BatchNorm; ReLU after the first two and after the residual sum."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 groups: int = 32, width_per_group: int = 8,
                 downsample: bool = False):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
            nn.BatchNorm2d(out_ch)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(h + identity)


def _layer(in_ch: int, planes: int, n: int, stride: int, groups: int,
           width_per_group: int) -> nn.Sequential:
    return nn.Sequential(*[
        Bottleneck(in_ch if b == 0 else planes * 4, planes,
                   stride if b == 0 else 1, groups, width_per_group,
                   downsample=(b == 0))
        for b in range(n)])


class ResNeXtBackbone(nn.Module):
    """4 feature taps at strides 4/8/16/32, channels 256/512/1024/2048."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 23, 3),
                 groups: int = 32, width_per_group: int = 8):
        super().__init__()
        gw = (groups, width_per_group)
        self.layer1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(),
            MaxPoolPadded(3, 2, pad=1), _layer(64, 64, layers[0], 1, *gw))
        self.layer2 = _layer(256, 128, layers[1], 2, *gw)
        self.layer3 = _layer(512, 256, layers[2], 2, *gw)
        self.layer4 = _layer(1024, 512, layers[3], 2, *gw)

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)
