"""Photo-like inputs made from the seed: the general generator that every
traffic file's ``photo`` block parameterizes.

An image is a smooth colour field (a coarse random grid, bicubic), a
mid-frequency texture, ``shapes`` flat-coloured ellipses and rectangles
with hard edges, and per-pixel noise, clipped to uint8 RGB: what a
decoded photo hands the funnel.  The pool is made on the device with a
generator seeded from the run's seed, in a few large calls per image,
and copied to the host once.  Every seed gives the same sizes; only the
content differs.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

INPUT_STREAM = 0x9E3779B97F4A7C15   # keeps the inputs' draws apart from
#                                     the weights' for the same seed


def _seed(seed: int) -> int:
    return (int(seed) * 2654435761 + INPUT_STREAM) % (1 << 63)


def photo_pool(spec: dict, count: int, seed: int, device) -> List[np.ndarray]:
    """``count`` distinct (height, width, 3) uint8 images by ``spec``
    (width, height, shapes, texture, noise)."""
    h, w = int(spec["height"]), int(spec["width"])
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    side = float(min(h, w))
    out = []
    for _ in range(count):
        base = F.interpolate(rand(1, 3, 5, 8), size=(h, w), mode="bicubic",
                             align_corners=False)[0] * 190.0 + 30.0
        tex = torch.randn((1, 3, max(h // 16, 2), max(w // 16, 2)),
                          generator=gen, device=device)
        img = base + float(spec["texture"]) * F.interpolate(
            tex, size=(h, w), mode="bilinear", align_corners=False)[0]
        geo = rand(int(spec["shapes"]), 8)
        for cy, cx, ry, rx, r, g, b, kind in geo.tolist():
            ry = (0.04 + 0.25 * ry) * side
            rx = (0.04 + 0.25 * rx) * side
            dy = (yy - cy * h) / ry
            dx = (xx - cx * w) / rx
            mask = (dy * dy + dx * dx <= 1.0) if kind < 0.5 else \
                ((dy.abs() <= 1.0) & (dx.abs() <= 1.0))
            colour = torch.tensor([r, g, b], device=device)[:, None, None]
            img = torch.where(mask[None], colour * 255.0, img)
        img = img + float(spec["noise"]) * torch.randn(
            (3, h, w), generator=gen, device=device)
        out.append(img.clamp(0, 255).round().to(torch.uint8)
                   .permute(1, 2, 0).contiguous())
    return [t.cpu().numpy() for t in out]
