"""Stereoscopic image generation: the polylines fills and the 8 modes.

Port of ``depthmap_tpu/ops/stereo.py``.  The polylines fills run kernel K2
(ops/polylines.py) on the depth map's device; the warp-based fills
("none", "naive", "naive_interpolating") are not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from depthmap_tpu_torch.device import resolve_device
from depthmap_tpu_torch.ops.polylines import polylines_rasterize

STEREO_MODES = ("left-right", "right-left", "top-bottom", "bottom-top",
                "red-cyan-anaglyph", "left-only", "only-right",
                "cyan-red-reverseanaglyph")
FILL_TECHNIQUES = ("none", "naive", "naive_interpolating", "polylines_soft",
                   "polylines_sharp")
_NOT_PORTED = ("stereo fill {!r} is not ported yet (ROADMAP Queue 1 item 4: "
               "the warp fills)")


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """(depth - min) / (max - min) in f32 (NaN for a flat map, as in the
    JAX package)."""
    depth = depth.to(torch.float32)
    dmin = torch.min(depth)
    dmax = torch.max(depth)
    return (depth - dmin) / (dmax - dmin)


def apply_stereo_divergence(image: torch.Tensor, depth: torch.Tensor,
                            divergence: float, separation: float,
                            exponent: float,
                            fill_technique: str) -> torch.Tensor:
    """One eye: image (H, W, C) uint8 and depth (H, W), on one device."""
    if tuple(image.shape[:2]) != tuple(depth.shape):
        raise ValueError("Depthmap and the image must have the same size")
    if fill_technique in ("none", "naive", "naive_interpolating"):
        raise NotImplementedError(_NOT_PORTED.format(fill_technique))
    if fill_technique not in ("polylines_soft", "polylines_sharp"):
        raise ValueError(f"Unknown fill technique {fill_technique!r}")
    nd = normalize_depth(depth)
    w = image.shape[1]
    divergence_px = (divergence / 100.0) * w
    separation_px = (separation / 100.0) * w
    return polylines_rasterize(image.to(torch.uint8), nd,
                               float(divergence_px), float(separation_px),
                               float(exponent),
                               fill_technique == "polylines_sharp")


def overlap_red_cyan(im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """R from im1, G+B from im2."""
    return torch.stack([im1[..., 0], im2[..., 1], im2[..., 2]], dim=-1)


def create_stereoimages(original_image, depthmap, divergence, separation=0.0,
                        modes: Sequence[str] | str | None = None,
                        stereo_balance=0.0, stereo_offset_exponent=1.0,
                        fill_technique="polylines_sharp",
                        device=None) -> List[np.ndarray]:
    """Returns uint8 numpy arrays, one per mode.  ``device`` defaults to
    the depth map's device when it is a tensor, else to the card ("cuda",
    which raises without CUDA); the CPU runs only when asked for."""
    if modes is None:
        modes = ["left-right"]
    if not isinstance(modes, (list, tuple)):
        modes = [modes]
    if len(modes) == 0:
        return []
    if device is None:
        device = depthmap.device if isinstance(depthmap, torch.Tensor) \
            else "cuda"
    device = resolve_device(device)
    image = torch.as_tensor(np.asarray(original_image), device=device)
    depth = torch.as_tensor(np.asarray(depthmap) if not isinstance(
        depthmap, torch.Tensor) else depthmap, device=device)
    balance = (stereo_balance + 1) / 2
    make_left = balance >= 0.001
    make_right = balance <= 0.999
    left_eye = image if not make_left else \
        apply_stereo_divergence(image, depth, +1 * divergence * balance,
                                -1 * separation, stereo_offset_exponent,
                                fill_technique)
    right_eye = image if not make_right else \
        apply_stereo_divergence(image, depth,
                                -1 * divergence * (1 - balance), separation,
                                stereo_offset_exponent, fill_technique)

    results = []
    for mode in modes:
        if mode == "left-right":
            results.append(torch.hstack([left_eye, right_eye]))
        elif mode == "right-left":
            results.append(torch.hstack([right_eye, left_eye]))
        elif mode == "top-bottom":
            results.append(torch.vstack([left_eye, right_eye]))
        elif mode == "bottom-top":
            results.append(torch.vstack([right_eye, left_eye]))
        elif mode == "red-cyan-anaglyph":
            results.append(overlap_red_cyan(left_eye, right_eye))
        elif mode == "left-only":
            results.append(left_eye)
        elif mode == "only-right":
            results.append(right_eye)
        elif mode == "cyan-red-reverseanaglyph":
            results.append(overlap_red_cyan(right_eye, left_eye))
        else:
            raise ValueError("Unknown mode")
    return [r.cpu().numpy() for r in results]
