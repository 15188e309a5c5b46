"""Stereoscopic image generation: the five fills and the 8 modes.

Port of ``depthmap_tpu/ops/stereo.py``, on the depth map's device.  The
polylines fills run kernel K2 (ops/polylines.py).  The warp fills ("none",
"naive", "naive_interpolating") are plain torch, as they are XLA in the
JAX package: a scatter-max forward warp, then a gap fill.  The JAX package
runs "naive_interpolating" through a host C++ fill; the port runs its
single-pass version, which gives the same bytes (the note of
``_fill_naive_interpolating``).  Every warp function takes any leading
batch axes: images (..., H, W, C), depth (..., H, W).
"""
from __future__ import annotations

import math
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
WARP_FILLS = ("none", "naive", "naive_interpolating")


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """(depth - min) / (max - min) in f32 (NaN for a flat map, as in the
    JAX package)."""
    depth = depth.to(torch.float32)
    dmin = torch.min(depth)
    dmax = torch.max(depth)
    return (depth - dmin) / (dmax - dmin)


def _f32(x: float) -> float:
    """A Python float rounded to f32, as XLA takes a weakly typed scalar
    into an f32 computation."""
    return float(np.float32(x))


def _warp(image: torch.Tensor, nd: torch.Tensor, divergence_px: float,
          separation_px: float, exponent: float):
    """Forward warp: (derived, filled).  A source column s lands at s +
    trunc(nd^exponent * divergence_px + separation_px); of the sources that
    land on one column, the smallest wins when divergence >= 0 and the
    largest otherwise (the sweep order of the reference's loop).  Offsets
    outside the static window of the JAX loop, and NaN offsets (a flat
    map), follow XLA: NaN converts to 0, out-of-window offsets land
    nowhere.  The offset is XLA's FMA (one rounding), computed in f64: the
    product of two f32 values is exact there.  nd^exponent is an f32 pow;
    at a non-integer exponent it may differ from XLA's (or from another
    device's) in the last bit, which moves an offset only where it lies
    within that bit of an integer."""
    w = nd.shape[-1]
    p = (nd.to(torch.float32) ** exponent).double()
    offset = (p * _f32(divergence_px) + _f32(separation_px)).float().trunc()
    offset = torch.nan_to_num(offset, nan=0.0)
    lo = math.floor(min(0.0, divergence_px) + min(0.0, separation_px))
    hi = math.ceil(max(0.0, divergence_px) + max(0.0, separation_px))
    in_window = (offset >= lo) & (offset <= hi)
    cols = torch.arange(w, device=nd.device)
    target = cols + torch.where(in_window, offset, 0.0).long()
    ok = in_window & (target >= 0) & (target < w)
    # the winner has the largest key: the smallest source for
    # divergence >= 0, the largest otherwise
    key = (w - 1 - cols) if divergence_px >= 0 else cols
    best = torch.full(nd.shape, -1, dtype=torch.int64, device=nd.device)
    best.scatter_reduce_(-1, target.clamp(0, w - 1),
                         torch.where(ok, key, -1), "amax", include_self=True)
    filled = best >= 0
    src = (w - 1 - best) if divergence_px >= 0 else best
    src = src.clamp(0, w - 1)[..., None].expand(image.shape)
    derived = torch.where(filled[..., None], image.gather(-2, src),
                          torch.zeros((), dtype=image.dtype,
                                      device=image.device))
    return derived, filled


def _nearest(marked: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The nearest marked column at or right of each column (``reverse``:
    a running min from the right over column-or-big) or at or left of it
    (a running max over column-or-minus-big), along the last axis."""
    if reverse:
        return marked.flip(-1).cummin(-1).values.flip(-1)
    return marked.cummax(-1).values


def _fill_naive(derived: torch.Tensor, filled: torch.Tensor,
                divergence_px: float) -> torch.Tensor:
    """Each unfilled pixel takes its nearest filled neighbour within
    abs(int(divergence_px)) + 1 columns; the right one wins a tie."""
    w = filled.shape[-1]
    max_off = abs(int(divergence_px)) + 1
    big = 1 << 30
    cols = torch.arange(w, device=filled.device)
    right = _nearest(torch.where(filled, cols, big), reverse=True)
    left = _nearest(torch.where(filled, cols, -big), reverse=False)
    d_right, d_left = right - cols, cols - left
    take_r = ~filled & (d_right <= max_off) & (d_right <= d_left)
    take_l = ~filled & ~take_r & (d_left <= max_off)
    src = torch.where(take_r, right, torch.where(take_l, left, cols))
    src = src.clamp(0, w - 1)[..., None].expand(derived.shape)
    return derived.gather(-2, src)


def _fill_naive_interpolating(derived: torch.Tensor,
                              filled: torch.Tensor) -> torch.Tensor:
    """Segment interpolation fill (the reference's sequential sweep) in one
    pass.  Pixels whose colour sums to 0 and that are unfilled open a gap
    run [l, r); the run, and every black pixel after it up to the next
    non-black one, interpolates between derived[l - 1] and that next
    non-black pixel derived[r], wrapping to uint8 mod 256 as the
    reference's ``astype(np.uint8)`` does.  As the JAX package's note says,
    the sweep's re-entrant case only ever rewrites black with black, so
    this single pass gives the sweep's bytes."""
    w = filled.shape[-1]
    big = 1 << 30
    cols = torch.arange(w, device=filled.device).expand(filled.shape)
    csum = derived.to(torch.int32).sum(-1)
    qualify = csum != 0                      # can be a run's right border
    gap = (csum == 0) & ~filled              # opens a run
    q_right = _nearest(torch.where(qualify, cols, big), reverse=True)
    # pixels strictly between two non-black ones share a segment
    seg = qualify.long().cumsum(-1)
    first_gap = torch.full((*filled.shape[:-1], w + 1), big,
                           dtype=torch.int64, device=filled.device)
    first_gap.scatter_reduce_(-1, seg, torch.where(gap, cols, big), "amin",
                              include_self=True)
    l_ptr = first_gap.gather(-1, seg)
    written = (csum == 0) & (l_ptr <= cols)
    r_ptr = torch.where(q_right >= big, w, q_right)

    def border(idx, outside):
        px = derived.gather(-2, idx.clamp(0, w - 1)[..., None].expand(
            derived.shape)).float()
        return torch.where(outside[..., None], 0.0, px)

    l_safe = l_ptr.clamp(0, w - 1)
    lb = border(l_safe - 1, l_safe - 1 < 0)
    rb = border(r_ptr, r_ptr >= w)
    lb_zero = lb.to(torch.int32).sum(-1, keepdim=True) == 0
    rb_zero = rb.to(torch.int32).sum(-1, keepdim=True) == 0
    lb_eff = torch.where(lb_zero, rb, lb)
    rb_eff = torch.where(rb_zero & ~lb_zero, lb, rb)
    total = (1 + r_ptr - l_ptr).float()[..., None]
    step = (rb_eff - lb_eff) / total
    k = (cols - l_ptr + 1).float()[..., None]
    delta = (step * k).trunc().to(torch.int32)
    val = (lb_eff.to(torch.int32) + delta) % 256
    return torch.where(written[..., None], val.to(derived.dtype), derived)


def apply_stereo_divergence_naive(image: torch.Tensor, nd: torch.Tensor,
                                  divergence_px: float, separation_px: float,
                                  exponent: float,
                                  fill_technique: str = "none"
                                  ) -> torch.Tensor:
    """The warp, then the fill: image (..., H, W, C) uint8, normalized
    depth (..., H, W) -> (..., H, W, C) uint8."""
    if fill_technique not in WARP_FILLS:
        raise ValueError(f"Unknown warp fill {fill_technique!r}")
    derived, filled = _warp(image, nd, float(divergence_px),
                            float(separation_px), float(exponent))
    if fill_technique == "naive":
        return _fill_naive(derived, filled, float(divergence_px))
    if fill_technique == "naive_interpolating":
        return _fill_naive_interpolating(derived, filled)
    return derived


def stereo_pair_batch(images: torch.Tensor, nds: torch.Tensor,
                      left_div: float, right_div: float, left_sep: float,
                      right_sep: float, exponent: float,
                      fill_technique: str = "naive", make_left: bool = True,
                      make_right: bool = True):
    """Both eyes of a batch: images (N, H, W, C) uint8, normalized depth
    (N, H, W) -> (left, right) stacks; an eye not made is the image."""
    left = right = images
    if make_left:
        left = apply_stereo_divergence_naive(images, nds, left_div, left_sep,
                                             exponent, fill_technique)
    if make_right:
        right = apply_stereo_divergence_naive(images, nds, right_div,
                                              right_sep, exponent,
                                              fill_technique)
    return left, right


def apply_stereo_divergence(image: torch.Tensor, depth: torch.Tensor,
                            divergence: float, separation: float,
                            exponent: float,
                            fill_technique: str) -> torch.Tensor:
    """One eye: image (H, W, C) uint8 and depth (H, W), on one device."""
    if tuple(image.shape[:2]) != tuple(depth.shape):
        raise ValueError("Depthmap and the image must have the same size")
    if fill_technique not in FILL_TECHNIQUES:
        raise ValueError(f"Unknown fill technique {fill_technique!r}")
    nd = normalize_depth(depth)
    w = image.shape[1]
    divergence_px = (divergence / 100.0) * w
    separation_px = (separation / 100.0) * w
    if fill_technique in WARP_FILLS:
        return apply_stereo_divergence_naive(image, nd, divergence_px,
                                             separation_px, exponent,
                                             fill_technique)
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
