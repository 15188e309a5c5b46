"""Image resizing: thin ``F.interpolate`` calls on NCHW tensors, JAX's
``scale_and_translate`` and the cv2 resizes Boost and Marigold make (on
the host, and Marigold's cubic one also on the device).

The JAX package rebuilds torch's interpolation semantics from explicit tap
matrices (depthmap_tpu/ops/resize.py); here torch's own operator is those
semantics.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# torch's CUDA upsampling kernels refuse an output of more elements than
# a 32-bit int holds; ``interpolate`` resizes a larger batch a few
# images at a time (each image is resized on its own either way)
MAX_RESIZE_ELEMENTS = 2 ** 31 - 1


def interpolate(x: torch.Tensor, size, mode: str = "bilinear",
                align_corners: bool = False, scales=None) -> torch.Tensor:
    """Resize the two trailing spatial axes of an NCHW tensor to ``size``
    (out_h, out_w).  Matching sizes are returned as they are (torch's
    bilinear and bicubic taps are the identity there).  ``scales=(sh, sw)``
    maps coordinates by torch's explicit ``scale_factor`` instead of the
    size ratio; the output size it gives must be ``size``."""
    out_h, out_w = int(size[0]), int(size[1])
    if scales is not None:
        out = F.interpolate(x, scale_factor=tuple(scales), mode=mode,
                            align_corners=align_corners)
        if tuple(out.shape[-2:]) != (out_h, out_w):
            raise ValueError(f"scale_factor {tuple(scales)} gives "
                             f"{tuple(out.shape[-2:])}, not {(out_h, out_w)}")
        return out
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    per_image = x.shape[1] * out_h * out_w
    if x.shape[0] * per_image <= MAX_RESIZE_ELEMENTS or x.shape[0] == 1:
        return F.interpolate(x, size=(out_h, out_w), mode=mode,
                             align_corners=align_corners)
    step = max(1, MAX_RESIZE_ELEMENTS // per_image)
    return torch.cat([F.interpolate(p, size=(out_h, out_w), mode=mode,
                                    align_corners=align_corners)
                      for p in x.split(step)])


def scale2x(x: torch.Tensor, mode: str = "bilinear",
            align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(scale_factor=2) equivalent."""
    return interpolate(x, (2 * x.shape[-2], 2 * x.shape[-1]), mode,
                       align_corners)


# -- jax.image.scale_and_translate ----------------------------------------
# Boost crops, places and blends its patches with JAX's resampler, whose
# "cubic" is Keys' kernel with a = -0.5 (torch's bicubic has a = -0.75)
# and whose samples outside the input get no weight, the rest of each row
# renormalized.  The per-axis (out, in) weight matrices are built as JAX
# builds them, in f32, and applied with two batched matmuls.

def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in f32, rounded once (the product of two f32 values is
    exact in f64); ``b`` and ``c`` may be Python floats."""
    return (a.double() * b + c).to(torch.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    inner = _fma(_fma(x, 1.5, -2.5) * x, x, 1.0)
    outer = _fma(_fma(_fma(x, -0.5, 2.5), x, -4.0), x, 2.0)
    out = torch.where(x >= 1.0, outer, inner)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def scale_translate_weights(in_size: int, out_size: int,
                            inv_scale: torch.Tensor, shift: torch.Tensor,
                            method: str) -> torch.Tensor:
    """(B, out_size, in_size) f32 weights of jax.image.scale_and_translate
    (``antialias=False``) along one axis, from B f32 inverse scales and
    shifts (translation x inverse scale): output pixel i samples the input
    at (i + 0.5) * inv_scale - shift - 0.5.  Each multiply-add is rounded
    once, as the JAX package's XLA CPU build fuses it (a product rounded
    apart moves a sample by an ulp of its coordinate, its weights by up to
    ~4e-5)."""
    dev = inv_scale.device
    centre = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample = _fma(centre[None], inv_scale.to(torch.float32)[:, None].double(),
                  -shift.to(torch.float32)[:, None].double()) - 0.5  # (B, out)
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = _KERNELS[method]((sample[:, :, None] - src[None, None]).abs())
    total = w.sum(-1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def scale_and_translate(x: torch.Tensor, out_hw, inv_scale: torch.Tensor,
                        shift: torch.Tensor, method: str) -> torch.Tensor:
    """jax.image.scale_and_translate over the two trailing axes of ``x``
    (..., H, W), once per row of ``inv_scale`` / ``shift`` (B, 2), each
    (y, x) and each as the JAX program computes it (XLA folds 1 / (c / v)
    into v * (1 / c)): -> (B, ..., out_h, out_w) f32."""
    h, w = x.shape[-2:]
    wy = scale_translate_weights(h, int(out_hw[0]), inv_scale[:, 0],
                                 shift[:, 0], method)
    wx = scale_translate_weights(w, int(out_hw[1]), inv_scale[:, 1],
                                 shift[:, 1], method)
    shape = (wy.shape[0],) + (1,) * (x.dim() - 2)
    wy = wy.reshape(shape + wy.shape[1:])
    wx = wx.reshape(shape + wx.shape[1:])
    return torch.matmul(torch.matmul(wy, x.to(torch.float32)[None]),
                        wx.transpose(-1, -2))


# -- cv2 on the host, without cv2 ----------------------------------------
# What Boost and Marigold ask of OpenCV, restated in numpy: cv2.resize's
# INTER_LINEAR (source index and weights in f64, as cv2 computes them for a
# CV_64F image; its edges clamp), its INTER_CUBIC on a float32 image (Keys'
# a = -0.75, the weights computed in f64 and rounded to f32, clamped edges),
# and cv2.dilate with an all-ones kernel.  Held against cv2 by
# tests/test_torch_port_boost.py: the linear resize to the last bits of
# f64, the cubic to a few f32 ulps, the dilation exactly.

def _cv2_taps(in_size: int, out_size: int, cubic: bool):
    """(out_size, taps) source indices and f64 weights of cv2.resize."""
    scale = in_size / out_size
    fx = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    if cubic:
        a = -0.75
        c0 = ((a * (fx + 1) - 5 * a) * (fx + 1) + 8 * a) * (fx + 1) - 4 * a
        c1 = ((a + 2) * fx - (a + 3)) * fx * fx + 1
        c2 = ((a + 2) * (1 - fx) - (a + 3)) * (1 - fx) * (1 - fx) + 1
        w = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1)
        idx = sx[:, None] + np.arange(-1, 3)[None]
    else:
        low, high = sx < 0, sx >= in_size - 1
        fx[low | high] = 0.0
        sx[low] = 0
        sx[high] = in_size - 1
        w = np.stack([1 - fx, fx], -1)
        idx = sx[:, None] + np.arange(2)[None]
    return np.clip(idx, 0, in_size - 1), w


def _cv2_resize(img: np.ndarray, size, cubic: bool) -> np.ndarray:
    out_w, out_h = int(size[0]), int(size[1])
    ix, wx = _cv2_taps(img.shape[1], out_w, cubic)
    iy, wy = _cv2_taps(img.shape[0], out_h, cubic)
    if cubic:   # cv2 keeps a float32 image's weights in f32
        wx = wx.astype(np.float32).astype(np.float64)
        wy = wy.astype(np.float32).astype(np.float64)
    x = np.asarray(img, np.float64)
    tail = (None,) * (x.ndim - 2)
    t = sum(x[:, ix[:, k]] * wx[(slice(None), k) + tail]
            for k in range(ix.shape[1]))
    if cubic:   # the horizontal pass's f32 row buffer
        t = t.astype(np.float32).astype(np.float64)
    out = sum(t[iy[:, k]] * wy[(slice(None), k, None) + tail]
              for k in range(iy.shape[1]))
    return out.astype(img.dtype)


def cv2_resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size) of an f64 map (INTER_LINEAR, the default: the
    JAX package's ``cv2.resize(grad, size, cv2.INTER_AREA)`` passes the
    flag where cv2 takes ``dst``, so cv2 interpolates linearly).
    ``size`` is (width, height)."""
    return _cv2_resize(np.asarray(img, np.float64), size, cubic=False)


def cv2_resize_cubic(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_CUBIC) of a float32
    (H, W) or (H, W, C) image; ``size`` is (width, height)."""
    return _cv2_resize(np.asarray(img, np.float32), size, cubic=True)


def cv2_resize_cubic_t(x: torch.Tensor, size) -> torch.Tensor:
    """``cv2_resize_cubic`` on the device: the trailing (H, W) axes of an
    f32 tensor, the same taps, f32-rounded weights, f64 sums in the same
    order and the f32 row buffer, so the result is numpy's bit for bit.
    ``size`` is (width, height)."""
    out_w, out_h = int(size[0]), int(size[1])
    dev = x.device

    def taps(in_size, out_size):
        idx, w = _cv2_taps(in_size, out_size, cubic=True)
        w = w.astype(np.float32).astype(np.float64)
        return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)
    ix, wx = taps(x.shape[-1], out_w)
    iy, wy = taps(x.shape[-2], out_h)
    x = x.to(torch.float64)
    t = sum(x.index_select(-1, ix[:, k]) * wx[:, k]
            for k in range(ix.shape[1]))
    t = t.to(torch.float32).to(torch.float64)
    out = sum(t.index_select(-2, iy[:, k]) * wy[:, k, None]
              for k in range(iy.shape[1]))
    return out.to(torch.float32)


def cv2_dilate(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.dilate(img, np.ones((k, k)), iterations=1): the max over a k x k
    window with cv2's default anchor k // 2 (so an even window reaches one
    pixel further up and left than down and right); outside the image
    counts as -inf.  An empty kernel (k = 0) is cv2's default 3 x 3."""
    from numpy.lib.stride_tricks import sliding_window_view
    k = k if k > 0 else 3
    a = k // 2
    p = np.pad(np.asarray(img), ((a, k - 1 - a), (a, k - 1 - a)),
               constant_values=-np.inf)
    return sliding_window_view(p, (k, k)).max(axis=(-2, -1))


def cv2_resize_area_u8(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_AREA) of a uint8
    (H, W[, C]) image whose size divides by ``size`` (width, height) by one
    integer factor f: each f x f block's integer sum, over 4 rounded half
    up for f = 2 (cv2's vector path), else times f32 1 / f^2 rounded to
    nearest even (its scalar path)."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    f = h // out_h
    if f < 1 or (out_h * f, out_w * f) != (h, w):
        raise ValueError(f"INTER_AREA restated for integer factors only: "
                         f"{(h, w)} -> {(out_h, out_w)}")
    if f == 1:
        return np.array(img)
    s = np.asarray(img, np.int64).reshape(
        out_h, f, out_w, f, *img.shape[2:]).sum(axis=(1, 3))
    if f == 2:
        return ((s + 2) >> 2).astype(np.uint8)
    return np.rint(s.astype(np.float32) *
                   np.float32(1.0 / (f * f))).astype(np.uint8)
