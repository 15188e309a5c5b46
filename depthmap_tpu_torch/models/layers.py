"""Shared NCHW building blocks of the conv models, and tiling mode.

Port of ``depthmap_tpu/models/layers.py``: TF 'SAME' padding
(``tf_same_pads``, ``ConvSame``), conv-BN-act (its BatchNorm is
``nn.BatchNorm2d`` in eval mode: eps 1e-5 for the ResNeXt, 1e-3 for
EfficientNet-Lite), and the tiling-mode switch.  The reference
monkey-patches every Conv2d to circular padding for seamless tiles; the
JAX package switches a
module-global flag that reaches exactly its ``Conv`` (padding > 0) and
``ConvSame`` (wrap pads).  Here it is a property of each built model, set
by ``set_tiling_mode``, and reaches the same layers: every ``nn.Conv2d``
with padding, and every ``ConvSame``.  What the JAX flag leaves zero- or
-inf-padded (the hybrid's weight-standardized convs, both max-pools) pads
explicitly with ``F.pad`` before a padding-0 conv or pool, which the
switch does not touch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def tf_same_pads(in_size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME padding (lo, hi) of one spatial dim."""
    if in_size % s == 0:
        total = max(k - s, 0)
    else:
        total = max(k - in_size % s, 0)
    return (total // 2, total - total // 2)


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0,
             circular: bool = False) -> torch.Tensor:
    """``x`` (N, C, H, W) padded by TF SAME for a k x k window at stride s:
    with ``value``, or wrapped around (``circular``)."""
    ph = tf_same_pads(x.shape[2], k, s)
    pw = tf_same_pads(x.shape[3], k, s)
    if max(ph + pw) == 0:
        return x
    if circular:
        return F.pad(x, (*pw, *ph), mode="circular")
    return F.pad(x, (*pw, *ph), value=value)


class ConvSame(nn.Conv2d):
    """Conv2d with TF 'SAME' asymmetric padding (the reference's
    Conv2dSameExport); ``circular`` is its tiling-mode switch."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride, 0, groups=groups,
                         bias=bias)
        self.circular = False

    def forward(self, x):
        x = same_pad(x, self.kernel_size[0], self.stride[0],
                     circular=self.circular)
        return super().forward(x)


class MaxPoolPadded(nn.Module):
    """3x3 stride-2 max-pool over an explicit -inf pad: ``pad`` on every
    side (the ResNeXt stem's), or TF SAME when None (timm's
    MaxPool2dSame)."""

    def __init__(self, kernel: int = 3, stride: int = 2,
                 pad: Optional[int] = None):
        super().__init__()
        self.kernel, self.stride, self.pad = kernel, stride, pad

    def forward(self, x):
        if self.pad is None:
            x = same_pad(x, self.kernel, self.stride, value=float("-inf"))
        else:
            x = F.pad(x, (self.pad,) * 4, value=float("-inf"))
        return F.max_pool2d(x, self.kernel, self.stride)


def conv_bn_act(x, conv: nn.Module, bn: nn.Module, act: bool = True):
    """ConvBnAct's forward: conv, BatchNorm, ReLU6 (when ``act``)."""
    x = bn(conv(x))
    return F.relu6(x) if act else x


def set_tiling_mode(module: nn.Module, enabled: bool) -> None:
    """Switch every padded Conv2d and every ConvSame of ``module`` to
    circular (tiling mode) or zero padding."""
    for m in module.modules():
        if isinstance(m, ConvSame):
            m.circular = bool(enabled)
        elif isinstance(m, nn.Conv2d) and any(p > 0 for p in m.padding):
            m.padding_mode = "circular" if enabled else "zeros"
