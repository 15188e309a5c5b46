"""Image resizing: thin ``F.interpolate`` calls on NCHW tensors.

The JAX package rebuilds torch's interpolation semantics from explicit tap
matrices (depthmap_tpu/ops/resize.py); here torch's own operator is those
semantics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate(x: torch.Tensor, size, mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Resize the two trailing spatial axes of an NCHW tensor to ``size``
    (out_h, out_w).  Matching sizes are returned as they are (torch's
    bilinear and bicubic taps are the identity there)."""
    out_h, out_w = int(size[0]), int(size[1])
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode=mode,
                         align_corners=align_corners)


def scale2x(x: torch.Tensor, mode: str = "bilinear",
            align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(scale_factor=2) equivalent."""
    return interpolate(x, (2 * x.shape[-2], 2 * x.shape[-1]), mode,
                       align_corners)
