"""Tiling mode for the conv models (NCHW).

The reference monkey-patches every Conv2d to circular padding for seamless
tiles; the JAX package (depthmap_tpu/models/layers.py) switches it with a
module-global flag.  Here it is a property of each built model, set by
``set_tiling_mode``.  ``ConvSame`` and ``BatchNorm`` wait for the models
that use them.
"""
from __future__ import annotations

import torch.nn as nn


def set_tiling_mode(module: nn.Module, enabled: bool) -> None:
    """Switch every padded Conv2d of ``module`` to circular (tiling mode)
    or zero padding."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and any(p > 0 for p in m.padding):
            m.padding_mode = "circular" if enabled else "zeros"
