"""Separable image filters with OpenCV's kernels and borders (torch).

Port of ``depthmap_tpu/ops/filters.py``: the normal map's
cv2.GaussianBlur(k, (k, k), k) and cv2.Sobel(..., ksize) with
BORDER_DEFAULT (REFLECT_101).  The kernel coefficients are built on the
host in f64, as cv2 builds them, and rounded to the map's dtype; the
separable correlation runs on the map's device, summed tap by tap in the
JAX package's order.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(ksize: int, sigma: float) -> tuple:
    """cv2.getGaussianKernel (its sigma > 0 branch), f64."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64)
    x = i - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return tuple(k.tolist())


@functools.lru_cache(maxsize=None)
def deriv_kernel1d(order: int, ksize: int) -> tuple:
    """cv2.getDerivKernels for Sobel: binomial smoothing
    [1,1]^(ksize-1-order) convolved with the difference [-1,1]^order."""
    assert ksize % 2 == 1 and ksize >= 1
    if ksize == 1:
        return tuple({0: [1.0], 1: [-1.0, 0.0, 1.0]}[order])  # cv2: 1x3
    k = np.array([1.0])
    for _ in range(ksize - 1 - order):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [-1.0, 1.0])
    return tuple(k.tolist())


def _corr(arr: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """Valid correlation of ``arr`` with the taps ``k`` along ``axis``,
    summed from tap 0 up."""
    n, size = k.shape[0], arr.shape[axis]
    out = torch.zeros_like(arr.narrow(axis, n - 1, size - n + 1))
    for i in range(n):
        out = out + k[i] * arr.narrow(axis, i, size - n + 1)
    return out


def sep_filter2d(x: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable correlation (cv2.sepFilter2D: the kernels applied as
    correlation, REFLECT_101 border); kx runs along the width, ky along
    the height.  Works on (H, W) or (H, W, C)."""
    kx = torch.tensor(kx, dtype=x.dtype, device=x.device)
    ky = torch.tensor(ky, dtype=x.dtype, device=x.device)
    rx, ry = (kx.shape[0] - 1) // 2, (ky.shape[0] - 1) // 2
    squeeze = x.dim() == 2
    chw = x[None] if squeeze else x.permute(2, 0, 1)
    xp = F.pad(chw[None], (rx, rx, ry, ry), mode="reflect")[0]
    out = _corr(_corr(xp, kx, 2), ky, 1)
    return out[0] if squeeze else out.permute(1, 2, 0)


def gaussian_blur(x: torch.Tensor, ksize: Optional[int],
                  sigma: Optional[float] = None) -> torch.Tensor:
    """cv2.GaussianBlur(x, (ksize, ksize), sigma) (sigmaY = sigmaX)."""
    if ksize is None or ksize <= 0:
        return x
    if ksize % 2 == 0:
        # cv2 asserts "ksize.width must be positive and odd"; the valid
        # correlation would silently shrink the image by one pixel
        raise ValueError(f"gaussian_blur ksize must be odd, got {ksize}")
    k = gaussian_kernel1d(int(ksize), float(ksize if sigma is None
                                            else sigma))
    return sep_filter2d(x, k, k)


def sobel(x: torch.Tensor, dx: int, dy: int, ksize: int = 3) -> torch.Tensor:
    """cv2.Sobel(x, CV_32F, dx, dy, ksize)."""
    return sep_filter2d(x, deriv_kernel1d(dx, ksize),
                        deriv_kernel1d(dy, ksize))


def np_gradient_2d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """numpy.gradient of a 2-D map: (d/dy, d/dx), central differences
    inside and one-sided at the edges."""
    def grad(a, axis):
        n = a.shape[axis]
        interior = (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) / 2.0
        first = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
        last = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
        return torch.cat([first, interior, last], axis)
    return grad(x, 0), grad(x, 1)


# -- the 3D photo's host filters (numpy), restated from cv2 and held
# against it by tests/test_torch_port_inpaint.py --------------------------

# cv2's bit-exact 8-bit Gaussian: for sigma 0 and k <= 7 its fixed kernels
# in units of 1/256 (getGaussianKernelBitExact), applied in integers
_GAUSS_U8 = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
             7: (8, 28, 56, 72, 56, 28, 8)}


def cv2_gaussian_blur_u8(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) of a uint8 (H, W[, C]) image for
    k in 3, 5, 7: the separable integer kernel, REFLECT_101 border, the
    sum over 1/65536 rounded half up."""
    taps = np.asarray(_GAUSS_U8[ksize], np.int64)
    r = ksize // 2
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    x = np.pad(np.asarray(img, np.int64), pad, mode="reflect")
    h, w = img.shape[:2]
    rows = sum(taps[i] * x[:, i:i + w] for i in range(ksize))
    total = sum(taps[i] * rows[i:i + h] for i in range(ksize))
    return ((total + 32768) >> 16).astype(np.uint8)


def cv2_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.blur(img, ksize=(3, 3)) of a float32 (H, W) map: the 3 x 3 mean
    in f64 (as cv2 sums a float image), REFLECT_101 border, rounded to
    f32."""
    h, w = img.shape
    x = np.pad(np.asarray(img, np.float64), 1, mode="reflect")
    total = sum(x[i:i + h, j:j + w] for i in range(3) for j in range(3))
    return (total * (1.0 / 9.0)).astype(np.float32)
