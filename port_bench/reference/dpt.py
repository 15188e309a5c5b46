"""The DPT decoder in plain PyTorch (MiDaS 3.1's ``midas/blocks.py``:
``_make_scratch``, ``ResidualConvUnit_custom`` without batch norm,
``FeatureFusionBlock_custom`` with align_corners=True and no expansion),
shared by MiDaS's DPT and Depth Anything v2's head, which name its
weights alike under ``<prefix>scratch.``."""
from __future__ import annotations

import torch.nn.functional as F

from port_bench.reference.common import Numerics


def _conv(nx: Numerics, w: dict, name: str, x, padding=1, stride=1,
          bias=True):
    return nx.conv(x, w[f"{name}.weight"],
                   w[f"{name}.bias"] if bias else None, stride=stride,
                   padding=padding)


def _rcu(nx, w, name, x):
    """ResidualConvUnit_custom: relu, conv3x3, relu, conv3x3, + x."""
    out = _conv(nx, w, f"{name}.conv1", F.relu(x))
    out = _conv(nx, w, f"{name}.conv2", F.relu(out))
    return out + x


def _fusion(nx, w, name, x, skip=None, size=None):
    """FeatureFusionBlock_custom: x (+ resConfUnit1(skip)), resConfUnit2,
    bilinear (align_corners=True) to ``size`` or 2x, out_conv 1x1."""
    out = x
    if skip is not None:
        out = out + _rcu(nx, w, f"{name}.resConfUnit1", skip)
    out = _rcu(nx, w, f"{name}.resConfUnit2", out)
    if size is None:
        size = (2 * out.shape[2], 2 * out.shape[3])
    out = F.interpolate(out, size=tuple(size), mode="bilinear",
                        align_corners=True)
    return _conv(nx, w, f"{name}.out_conv", out, padding=0)


def fuse(nx: Numerics, w: dict, prefix: str, layers):
    """The four reassembled maps -> refinenet1's output: layer{i}_rn
    (3x3, no bias), then refinenet4 .. 1, each fused to the next finer
    level's size, the last by 2x."""
    s = f"{prefix}scratch"
    r = [_conv(nx, w, f"{s}.layer{i + 1}_rn", h, bias=False)
         for i, h in enumerate(layers)]
    p = _fusion(nx, w, f"{s}.refinenet4", r[3], size=r[2].shape[2:])
    p = _fusion(nx, w, f"{s}.refinenet3", p, r[2], size=r[1].shape[2:])
    p = _fusion(nx, w, f"{s}.refinenet2", p, r[1], size=r[0].shape[2:])
    return _fusion(nx, w, f"{s}.refinenet1", p, r[0])


def midas_output(nx: Numerics, w: dict, p1):
    """MiDaS DPT's head (``scratch.output_conv``): conv3x3 to F/2, 2x
    bilinear (align_corners=True), conv3x3 to 32, relu, conv1x1 to 1,
    relu (non_negative) -> (B, h, w)."""
    out = _conv(nx, w, "scratch.output_conv.0", p1)
    out = F.interpolate(out, scale_factor=2, mode="bilinear",
                        align_corners=True)
    out = F.relu(_conv(nx, w, "scratch.output_conv.2", out))
    return F.relu(_conv(nx, w, "scratch.output_conv.4", out,
                        padding=0))[:, 0]


def depth_anything_output(nx: Numerics, w: dict, p1, out_hw):
    """Depth Anything v2's head: output_conv1 (3x3 to F/2), bilinear
    (align_corners=True) to 14 gh x 14 gw, output_conv2 (conv3x3 to 32,
    relu, conv1x1 to 1, relu), then the model's own relu -> (B, h, w)."""
    s = "depth_head.scratch"
    out = _conv(nx, w, f"{s}.output_conv1", p1)
    out = F.interpolate(out, size=tuple(out_hw), mode="bilinear",
                        align_corners=True)
    out = F.relu(_conv(nx, w, f"{s}.output_conv2.0", out))
    out = F.relu(_conv(nx, w, f"{s}.output_conv2.2", out, padding=0))
    return F.relu(out)[:, 0]
