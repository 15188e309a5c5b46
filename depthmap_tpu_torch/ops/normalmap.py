"""Normal map from a 16-bit depth map (torch, on the map's device).

Port of ``depthmap_tpu/ops/normalmap.py``: optional invert, /256, optional
Gaussian pre-blur, Sobel (or np.gradient) dz/dx and dz/dy, stack
(zx, -zy, 1), L2 normalize, optional post-blur and renormalize, then
uint8 by clip((n + 1) / 2 * 256, 0, 255.9), all in f32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from depthmap_tpu_torch.ops.filters import gaussian_blur, np_gradient_2d, sobel


def create_normalmap(depthmap, pre_blur: Optional[int] = None,
                     sobel_ksize: Optional[int] = 3,
                     post_blur: Optional[int] = None,
                     invert: bool = False, device=None) -> torch.Tensor:
    """depthmap: (H, W) uint16 (or float) tensor or array -> (H, W, 3)
    uint8 normal map on the tensor's device; an array goes to ``device``
    (default: the CPU)."""
    if isinstance(depthmap, np.ndarray):
        depthmap = torch.from_numpy(depthmap.astype(np.float32)).to(device)
    z = depthmap.to(torch.float32)
    if not invert:
        z = z * (-1.0)
    z = z / 256.0
    if pre_blur is not None and pre_blur > 0:
        z = gaussian_blur(z, pre_blur)
    if sobel_ksize is not None and sobel_ksize > 0:
        zx = sobel(z, 1, 0, ksize=sobel_ksize)
        zy = sobel(z, 0, 1, ksize=sobel_ksize)
    else:
        zy, zx = np_gradient_2d(z)
    normal = torch.stack([zx, -zy, torch.ones_like(z)], -1)
    normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    if post_blur is not None and post_blur > 0:
        normal = gaussian_blur(normal, post_blur)
        normal = normal / torch.linalg.vector_norm(normal, dim=-1,
                                                   keepdim=True)
    normal = (normal + 1.0) / 2.0
    return torch.clamp(normal * 256.0, 0.0, 256.0 - 0.1).to(torch.uint8)
