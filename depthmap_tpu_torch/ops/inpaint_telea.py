"""Telea's fast-marching inpainting, restated from OpenCV (numpy).

``cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA)`` of a uint8 (H, W, 3)
image, the fill the 3D photo uses where no inpainting checkpoint is there.
OpenCV's algorithm (photo/src/inpaint.cpp), step for step:

* a one-pixel frame around the image; ``f`` marks known (0), band (1) and
  inside (2) pixels; the band is the mask dilated by a 3 x 3 cross, minus
  the mask; T is 0 on the band and 1e6 elsewhere;
* first the distance outside the hole, up to ``radius`` (the mask dilated
  by a square of 2 radius + 1, minus the mask and the band), by fast
  marching from the band, stored negated;
* then the fill: fast marching inwards from the band; each pixel reached
  gets T from the 4-neighbour eikonal solve (``_solve``) and, per
  channel, the weighted mean of its known neighbours within ``radius``
  (weights: direction x level x 1 / distance^3) plus a gradient term,
  rounded to uint8.

Both marches pop the smallest T first and, on ties, the first pushed:
OpenCV's sorted list (``_Queue``).  The weights and sums are f32 as OpenCV
computes them (its distance and level terms through f64), summed in its
order (sequential, row by row), and its quirks are kept: the image
gradient's central difference times 2 and, on the image's first and last
rows and columns, samples shifted one pixel inwards.  Held byte-equal to
cv2 by tests/test_torch_port_inpaint.py.
"""
from __future__ import annotations

import heapq

import numpy as np

KNOWN, BAND, INSIDE, CHANGE = 0, 1, 2, 3
_F = np.float32


class _Queue:
    """OpenCV's priority list: pop the smallest T; equal T in push order."""

    def __init__(self):
        self._heap, self._n = [], 0

    def push(self, i: int, j: int, t: float) -> None:
        heapq.heappush(self._heap, (t, self._n, i, j))
        self._n += 1

    def push_all(self, marks: np.ndarray) -> None:
        """Every nonzero pixel, in raster order, at T = 0."""
        for i, j in zip(*np.nonzero(marks)):
            self.push(int(i), int(j), 0.0)

    def pop(self):
        if not self._heap:
            return None
        _, _, i, j = heapq.heappop(self._heap)
        return i, j


def _solve(i1, j1, i2, j2, f, t) -> float:
    """OpenCV's FastMarching_solve: T from two neighbours, in f64, returned
    as f32."""
    a11, a22 = float(t[i1, j1]), float(t[i2, j2])
    m12 = min(a11, a22)
    if f[i1, j1] != INSIDE:
        if f[i2, j2] != INSIDE:
            if abs(a11 - a22) >= 1.0:
                sol = 1 + m12
            else:
                sol = (a11 + a22 + np.sqrt(2 - (a11 - a22) * (a11 - a22))) \
                    * 0.5
        else:
            sol = 1 + a11
    elif f[i2, j2] != INSIDE:
        sol = 1 + a22
    else:
        sol = 1 + m12
    return float(_F(sol))


def _min4_solve(i, j, f, t) -> float:
    a = min(_solve(i - 1, j, i, j - 1, f, t), _solve(i + 1, j, i, j - 1, f, t))
    c = min(_solve(i - 1, j, i, j + 1, f, t), _solve(i + 1, j, i, j + 1, f, t))
    return min(a, c)


_NEIGHBOURS = ((-1, 0), (0, -1), (1, 0), (0, 1))


def _march_outside(f, t, queue) -> None:
    """icvCalcFMM with negate: the distance outside the hole, negated."""
    rows, cols = f.shape
    while True:
        p = queue.pop()
        if p is None:
            break
        ii, jj = p
        f[ii, jj] = CHANGE
        for di, dj in _NEIGHBOURS:
            i, j = ii + di, jj + dj
            if i <= 0 or j <= 0 or i > rows or j > cols:
                continue
            if f[i, j] == INSIDE:
                dist = _min4_solve(i, j, f, t)
                t[i, j] = dist
                f[i, j] = BAND
                queue.push(i, j, dist)
    changed = f == CHANGE
    f[changed] = KNOWN
    t[changed] = -t[changed]


def _seq_sum(start: np.float32, terms: np.ndarray) -> np.float32:
    """start + terms[0] + terms[1] + ... in f32, in order."""
    return np.cumsum(np.concatenate([[start], terms]).astype(_F),
                     dtype=_F)[-1]


def _fill(f, t, out, radius: int, queue) -> None:
    """icvTeleaInpaintFMM for 3 channels: ``out`` is the (H, W, 3) uint8
    image, f and t the framed (H + 2, W + 2) maps."""
    rows, cols = t.shape
    # the window's offsets in OpenCV's order (k rows, then l columns)
    dk, dl = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    dk, dl = dk.ravel(), dl.ravel()
    in_disc = dk * dk + dl * dl <= radius * radius
    img = out.astype(_F)
    while True:
        p = queue.pop()
        if p is None:
            break
        ii, jj = p
        f[ii, jj] = KNOWN
        for di, dj in _NEIGHBOURS:
            i, j = ii + di, jj + dj
            if i <= 0 or j <= 0 or i > rows - 1 or j > cols - 1:
                continue
            if f[i, j] != INSIDE:
                continue
            dist = _min4_solve(i, j, f, t)
            t[i, j] = dist
            tij = t[i, j]
            if f[i, j + 1] != INSIDE:
                gx = (t[i, j + 1] - t[i, j - 1]) * _F(0.5) \
                    if f[i, j - 1] != INSIDE else t[i, j + 1] - tij
            else:
                gx = tij - t[i, j - 1] if f[i, j - 1] != INSIDE else _F(0)
            if f[i + 1, j] != INSIDE:
                gy = (t[i + 1, j] - t[i - 1, j]) * _F(0.5) \
                    if f[i - 1, j] != INSIDE else t[i + 1, j] - tij
            else:
                gy = tij - t[i - 1, j] if f[i - 1, j] != INSIDE else _F(0)

            k, l = i + dk, j + dl
            ok = in_disc & (k > 0) & (l > 0) & (k < rows - 1) & \
                (l < cols - 1)
            k, l = k[ok], l[ok]
            ok = f[k, l] != INSIDE
            k, l = k[ok], l[ok]
            if len(k) == 0:
                sat = np.zeros(3, _F) + _F(0.5)
            else:
                ry = (i - k).astype(_F)
                rx = (j - l).astype(_F)
                len2 = rx * rx + ry * ry
                dst = (1.0 / (len2.astype(np.float64)
                              * np.sqrt(len2.astype(np.float64)))).astype(_F)
                lev = (1.0 / (1.0 + np.abs(t[k, l] - tij).astype(
                    np.float64))).astype(_F)
                dirv = rx * gx + ry * gy
                dirv = np.where(np.abs(dirv) <= 0.01, _F(0.000001), dirv)
                w = np.abs(dst * lev * dirv)
                km = k - 1 + (k == 1)
                kp = k - 1 - (k == rows - 2)
                lm = l - 1 + (l == 1)
                lp = l - 1 - (l == cols - 2)
                fr, fl = f[k, l + 1] != INSIDE, f[k, l - 1] != INSIDE
                fd, fu = f[k + 1, l] != INSIDE, f[k - 1, l] != INSIDE
                ia = img[k - 1, l - 1]      # the neighbour's own colour
                at = img[km, lm]            # its edge-shifted one
                gix = np.where(
                    (fr & fl)[:, None],
                    (img[km, lp + 1] - img[km, lm - 1]) * _F(2.0),
                    np.where((fr & ~fl)[:, None], img[km, lp + 1] - at,
                             np.where((~fr & fl)[:, None],
                                      img[km, lp] - img[km, lm - 1],
                                      _F(0))))
                giy = np.where(
                    (fd & fu)[:, None],
                    (img[kp + 1, lm] - img[km - 1, lm]) * _F(2.0),
                    np.where((fd & ~fu)[:, None], img[kp + 1, lm] - at,
                             np.where((~fd & fu)[:, None],
                                      img[kp, lm] - img[km - 1, lm],
                                      _F(0))))
                sat = np.empty(3, _F)
                for c in range(3):
                    ia_c = _seq_sum(_F(0), w * ia[:, c])
                    jx = -_seq_sum(_F(0), w * (gix[:, c] * rx))
                    jy = -_seq_sum(_F(0), w * (giy[:, c] * ry))
                    s = _seq_sum(_F(1.0e-20), w)
                    norm = np.sqrt(jx * jx + jy * jy) + _F(1.0e-20)
                    sat[c] = ia_c / s + (jx + jy) / norm + _F(0.5)
            val = np.clip(np.rint(sat), 0, 255).astype(np.uint8)
            out[i - 1, j - 1] = val
            img[i - 1, j - 1] = val
            f[i, j] = BAND
            queue.push(i, j, dist)


def _dilate(mask: np.ndarray, offsets) -> np.ndarray:
    out = np.zeros_like(mask)
    h, w = mask.shape
    for di, dj in offsets:
        out[max(di, 0):h + min(di, 0), max(dj, 0):w + min(dj, 0)] = \
            np.maximum(out[max(di, 0):h + min(di, 0),
                           max(dj, 0):w + min(dj, 0)],
                       mask[max(-di, 0):h + min(-di, 0),
                            max(-dj, 0):w + min(-dj, 0)])
    return out


def inpaint_telea(img: np.ndarray, mask: np.ndarray,
                  radius: float) -> np.ndarray:
    """cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA) of a uint8
    (H, W, 3) image and a uint8 (H, W) mask (nonzero: fill)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"Telea restated for uint8 (H, W, 3) images: "
                         f"{img.dtype} {img.shape}")
    rng = int(round(radius))
    h, w = mask.shape
    out = img.copy()
    framed = np.zeros((h + 2, w + 2), np.uint8)
    framed[1:-1, 1:-1] = np.where(np.asarray(mask) != 0, INSIDE, KNOWN)
    framed[0, :] = framed[-1, :] = framed[:, 0] = framed[:, -1] = 0
    cross = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    band = _dilate(framed, cross)
    band = np.where(band > framed, band - framed, 0).astype(np.uint8)
    band[0, :] = band[-1, :] = band[:, 0] = band[:, -1] = 0
    if not framed.any():
        return out
    f = np.zeros_like(framed)
    t = np.full(framed.shape, 1.0e6, _F)
    f[band != 0] = BAND
    f[framed != 0] = INSIDE
    t[band != 0] = 0
    heap = _Queue()
    heap.push_all(band)

    square = [(di, dj) for di in range(-rng, rng + 1)
              for dj in range(-rng, rng + 1)]
    ring = _dilate(framed, square)
    ring = np.where(ring > framed, ring - framed, 0).astype(np.uint8)
    outside = _Queue()
    outside.push_all(band)
    ring = np.where(ring > band, ring - band, 0).astype(np.uint8)
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = 0
    _march_outside(ring, t, outside)
    _fill(framed.copy(), t, out, rng, heap)
    return out
