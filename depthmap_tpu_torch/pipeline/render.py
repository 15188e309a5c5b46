"""Software mesh renderer for the 3D photo's trajectory videos (torch).

Port of ``depthmap_tpu/pipeline/render.py``, on the renderer's device:

* ``method="triangles"`` (``_raster``): faces projected by the pinhole
  camera, each covering the K x K block of pixel centres anchored at the
  floor of its screen bbox; taps outside the triangle, the canvas or from
  oversized / degenerate / behind-camera faces go to a drop bucket (index
  size * size of a buffer one longer, sliced off).  Pass 1 is the z-buffer
  (``scatter_reduce_`` "amin" of the perspective-correct depth); pass 2
  picks, per pixel, the winning tap (depth within 1 + 1e-4 of the buffer)
  with the largest global tap id (face, then row, then column of the
  block): the tap whose colour the JAX renderer's in-order scatter writes
  last, and an answer that no duplicate-index write order can change;
  pass 3 writes that tap's perspective-correct colour.  Each face runs
  with the smallest block past its own bbox (the K x K block's extra taps
  all fall outside the triangle), and taps go in chunks
  (``TAPS_PER_CHUNK``) to bound memory; the ids are the K x K block's, so
  neither changes the frame;
* ``method="splat"`` (``_splat``): each vertex splats a 3 x 3 block, the
  same two-pass z-buffer and winner rule (id: offset, then vertex).

K is measured per frame on the host (``_measure_footprint``: the p99.9
projected bbox extent + 3, snapped up a ladder and never shrinking), the
same numpy as the JAX renderer's, so the same faces drop.  The SSAA
chain (a uint8 Gaussian of k = ssaa // 2 * 2 + 1, then INTER_AREA down)
is numpy on the host, restated from cv2.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from depthmap_tpu_torch.device import resolve_device

_EPS = 1e-4      # the colour pass's depth tolerance, relative
# taps a chunk of faces may hold (each tap ~60 bytes across the passes'
# temporaries); the frame does not depend on it
TAPS_PER_CHUNK = 1 << 23


def _project(verts, cam_t, thf, size: int):
    """Screen coordinates and camera depth (the shared pinhole
    convention); ``cam_t`` and ``thf`` are tensors on the verts' device."""
    p = verts - cam_t
    z = -p[:, 2]
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    px = ((p[:, 0] / zs) / thf * 0.5 + 0.5) * (size - 1)
    py = (0.5 - (p[:, 1] / zs) / thf * 0.5) * (size - 1)
    return px, py, z


def _face_taps(px, py, z, colors, fc, size: int, K: int, with_color: bool):
    """One chunk of faces (C, 3) -> flat (C*K*K,) pixel index (size * size
    for a dropped tap), tap depth (inf when dropped) and, with
    ``with_color``, (C*K*K, 3) perspective-correct colours."""
    i0, i1, i2 = fc[:, 0], fc[:, 1], fc[:, 2]
    ax, ay, az = px[i0], py[i0], z[i0]
    bx, by, bz = px[i1], py[i1], z[i1]
    cx, cy, cz = px[i2], py[i2], z[i2]

    # signed double area; both windings render (no culling)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    x0 = torch.floor(torch.minimum(ax, torch.minimum(bx, cx))).to(torch.int32)
    y0 = torch.floor(torch.minimum(ay, torch.minimum(by, cy))).to(torch.int32)
    ext_x = torch.ceil(torch.maximum(ax, torch.maximum(bx, cx))).to(
        torch.int32) - x0
    ext_y = torch.ceil(torch.maximum(ay, torch.maximum(by, cy))).to(
        torch.int32) - y0
    nondegenerate = area.abs() > 1e-12
    ok_face = ((az > 1e-6) & (bz > 1e-6) & (cz > 1e-6) & nondegenerate
               & (ext_x < K) & (ext_y < K))
    inv_area = torch.where(nondegenerate, torch.reciprocal(area),
                           torch.zeros_like(area))
    iza, izb, izc = (torch.reciprocal(v) for v in (az, bz, cz))

    d = torch.arange(K, dtype=torch.int32, device=px.device)
    xg = x0[:, None] + d[None, :]                        # (C, K)
    yg = y0[:, None] + d[None, :]
    xf = xg.to(torch.float32)[:, None, :]                # (C, 1, K)
    yf = yg.to(torch.float32)[:, :, None]                # (C, K, 1)

    def e(v):
        return v[:, None, None]
    w0 = e(cx - bx) * (yf - e(by)) - e(cy - by) * (xf - e(bx))
    w1 = e(ax - cx) * (yf - e(cy)) - e(ay - cy) * (xf - e(cx))
    w2 = e(bx - ax) * (yf - e(ay)) - e(by - ay) * (xf - e(ax))
    b0, b1, b2 = w0 * e(inv_area), w1 * e(inv_area), w2 * e(inv_area)
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)

    # perspective-correct depth: 1/z is affine in screen space
    inv_z = torch.clamp(b0 * e(iza) + b1 * e(izb) + b2 * e(izc), min=1e-12)
    ztap = torch.reciprocal(inv_z)

    inb = ((xg >= 0) & (xg < size))[:, None, :] \
        & ((yg >= 0) & (yg < size))[:, :, None]
    ok = inside & inb & ok_face[:, None, None]
    lin = yg.to(torch.int64)[:, :, None] * size + xg.to(torch.int64)[:, None]
    drop = torch.full_like(lin, size * size)
    idx = torch.where(ok, lin, drop).reshape(-1)
    ztap = torch.where(ok, ztap, torch.full_like(ztap, float("inf")))
    ztap = ztap.reshape(-1)
    if not with_color:
        return idx, ztap, None
    ca, cb, cc = colors[i0], colors[i1], colors[i2]
    cnum = (b0[..., None] * (ca * iza[:, None])[:, None, None, :]
            + b1[..., None] * (cb * izb[:, None])[:, None, None, :]
            + b2[..., None] * (cc * izc[:, None])[:, None, None, :])
    ctap = (cnum / inv_z[..., None]).reshape(-1, 3)
    return idx, ztap, ctap


def _resolve(nb: int, chunks, device):
    """The shared z-buffer and winner rule.  ``chunks()`` yields (idx,
    ztap, gid, colour thunk) per chunk, with idx == nb for a dropped tap:
    pass 1 takes the depth minimum per pixel, pass 2 the largest id among
    the taps within 1 + 1e-4 of it, pass 3 writes the winners' colours over
    the gray background.  -> (nb, 3) f32."""
    zbuf = torch.full((nb + 1,), float("inf"), device=device)
    for idx, ztap, _, _ in chunks():
        zbuf.scatter_reduce_(0, idx, ztap, "amin")
    zbuf = zbuf[:nb]
    scale = torch.tensor(1 + _EPS, dtype=torch.float32, device=device)

    def winners(idx, ztap):
        won = ztap <= zbuf[idx.clamp(max=nb - 1)] * scale
        return torch.where(won & (idx < nb), idx, torch.full_like(idx, nb))

    best = torch.full((nb + 1,), -1, dtype=torch.int64, device=device)
    for idx, ztap, gid, _ in chunks():
        widx = winners(idx, ztap)
        best.scatter_reduce_(0, widx, torch.where(widx < nb, gid, -1),
                             "amax")
    rgb = torch.full((nb + 1, 3), 0.5, device=device)
    for idx, ztap, gid, color in chunks():
        widx = winners(idx, ztap)
        sel = (widx < nb) & (best[widx] == gid)
        rgb[widx[sel]] = color()[sel]
    return rgb[:nb]


_BLOCKS = (2, 3, 4, 6, 8, 12, 16)


def _raster(verts, colors, faces, cam_t, thf, size: int, K: int,
            taps_per_chunk: int) -> torch.Tensor:
    """Triangle z-buffer rasterization -> (size, size, 3) f32 in [0, 1]
    (gray background).  A face that the K x K block covers (bbox extent
    < K) runs with the smallest block of ``_BLOCKS`` past its own extent:
    every tap the K x K block adds lies a pixel or more outside its bbox,
    outside the triangle, so the pixels covered and their depths and
    colours are the same; tap ids stay those of the K x K block."""
    px, py, z = _project(verts, cam_t, thf, size)
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]

    def extent(q):
        a, b, c = q[i0], q[i1], q[i2]
        return torch.ceil(torch.maximum(a, torch.maximum(b, c))).to(
            torch.int32) - torch.floor(torch.minimum(a, torch.minimum(
                b, c))).to(torch.int32)
    ext = torch.maximum(extent(px), extent(py))
    area = (px[i1] - px[i0]) * (py[i2] - py[i0]) - \
        (py[i1] - py[i0]) * (px[i2] - px[i0])
    live = (z[i0] > 1e-6) & (z[i1] > 1e-6) & (z[i2] > 1e-6) & \
        (area.abs() > 1e-12) & (ext < K)
    blocks = torch.tensor([b for b in _BLOCKS if b < K] + [K],
                          device=verts.device)
    block = blocks[torch.searchsorted(blocks, ext + 1).clamp(
        max=len(blocks) - 1)]      # (dropped faces: past the last)
    kk = K * K
    face_ids = {int(b): torch.nonzero(live & (block == b))[:, 0]
                for b in blocks.tolist()}

    def chunks():
        for b, ids in face_ids.items():
            step = max(1, taps_per_chunk // (b * b))
            d = torch.arange(b, device=verts.device)
            taps = (d[:, None] * K + d[None, :]).reshape(-1)
            for s in range(0, ids.shape[0], step):
                fid = ids[s:s + step]
                fc = faces[fid]
                idx, ztap, _ = _face_taps(px, py, z, colors, fc, size, b,
                                          False)
                gid = (fid[:, None] * kk + taps[None]).reshape(-1)
                yield idx, ztap, gid, lambda fc=fc, b=b: _face_taps(
                    px, py, z, colors, fc, size, b, True)[2]
    return _resolve(size * size, chunks, verts.device).reshape(size, size, 3)


def _splat(verts, colors, cam_t, thf, size: int) -> torch.Tensor:
    """Point splat: each vertex covers a 3 x 3 block at its rounded screen
    position -> (size, size, 3) f32 (gray background)."""
    p = verts - cam_t
    z = -p[:, 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    px = ((p[:, 0] / zs) / thf * 0.5 + 0.5) * (size - 1)
    py = (0.5 - (p[:, 1] / zs) / thf * 0.5) * (size - 1)
    xi = torch.round(px).to(torch.int64)
    yi = torch.round(py).to(torch.int64)
    inb = valid & (xi >= -1) & (xi <= size) & (yi >= -1) & (yi <= size)
    nb = size * size
    n = verts.shape[0]
    idxs, zvals = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            xo, yo = xi + dx, yi + dy
            ok = inb & (xo >= 0) & (xo < size) & (yo >= 0) & (yo < size)
            idxs.append(torch.where(ok, yo * size + xo,
                                    torch.full_like(xo, nb)))
            zvals.append(torch.where(ok, z, torch.full_like(z,
                                                            float("inf"))))
    idx, ztap = torch.cat(idxs), torch.cat(zvals)
    gid = torch.arange(9 * n, device=verts.device)

    def chunks():
        yield idx, ztap, gid, lambda: colors.repeat(9, 1)
    return _resolve(nb, chunks, verts.device).reshape(size, size, 3)


class MeshRenderer:
    """One mesh on one device, with the reference's canvas conventions:
    a square canvas of ``canvas_size`` x ``ssaa`` pixels, rendered then
    blurred and area-downsampled back to ``canvas_size``."""

    # the footprint ladder: K re-measured per frame (faces grow under zoom
    # and the dolly's fov), snapped up and never shrinking
    _K_LADDER = (3, 4, 6, 8, 12, 16)

    def __init__(self, verts, colors, faces, fov_rad: float,
                 canvas_size: int, ssaa: int = 1,
                 method: str = "triangles", device="cuda"):
        self.device = resolve_device(device)
        self._verts_np = np.asarray(verts, np.float32)
        self.verts = torch.from_numpy(self._verts_np).to(self.device)
        colors = np.asarray(colors, np.float32)
        if colors.max() > 1.0 + 1e-6:
            colors = colors / 255.0
        self.colors = torch.from_numpy(np.ascontiguousarray(
            colors[:, :3])).to(self.device)
        self.fov_rad = fov_rad
        self.ssaa = max(int(ssaa), 1)
        self.size = int(canvas_size * self.ssaa)
        self.method = method
        faces = np.asarray(faces, np.int64)
        self._K = 0
        if method == "triangles" and len(faces):
            self._face_cols = [np.ascontiguousarray(faces[:, i])
                               for i in range(3)]
            self.faces = torch.from_numpy(faces).to(self.device)
            self._set_K(self._measure_footprint(np.zeros(3), self.fov_rad))
        else:
            self.method = "splat"
            self.faces = None

    def _set_K(self, k: int) -> None:
        self._K = max(self._K, k)

    def _measure_footprint(self, cam_t, fov: float) -> int:
        """The K x K tap block per face at this camera: the p99.9 projected
        bbox extent + 3, snapped up to the ladder (host numpy, as the JAX
        renderer measures it).  Faces past it are dropped at render
        time."""
        thf = float(np.tan(fov / 2.0))
        p = self._verts_np - np.asarray(cam_t, np.float32)
        z = -p[:, 2]
        zs = np.where(z > 1e-6, z, 1.0)
        px = (p[:, 0] / zs / thf * 0.5 + 0.5) * (self.size - 1)
        py = (0.5 - p[:, 1] / zs / thf * 0.5) * (self.size - 1)
        # the extents as fx.max(1) - fx.min(1), by columns (the same
        # values; numpy reduces a length-3 axis slowly)
        exts = []
        for q in (px, py):
            a, b, c = (q[col] for col in self._face_cols)
            exts.append(np.maximum(np.maximum(a, b), c)
                        - np.minimum(np.minimum(a, b), c))
        ext = np.maximum(*exts)
        k = int(np.clip(int(np.ceil(np.percentile(ext, 99.9))) + 3, 3, 16))
        for lk in self._K_LADDER:
            if k <= lk:
                return lk
        return self._K_LADDER[-1]

    def render_device(self, cam_t, fov_rad: Optional[float] = None
                      ) -> torch.Tensor:
        """The (size, size, 3) f32 frame at SSAA scale, on the device."""
        fov = fov_rad if fov_rad is not None else self.fov_rad
        thf = torch.tensor(float(np.tan(fov / 2.0)), dtype=torch.float32,
                           device=self.device)
        cam = torch.as_tensor(np.asarray(cam_t, np.float32),
                              device=self.device)
        if self.method == "triangles":
            self._set_K(self._measure_footprint(cam_t, fov))
            return _raster(self.verts, self.colors, self.faces, cam, thf,
                           self.size, self._K, TAPS_PER_CHUNK)
        return _splat(self.verts, self.colors, cam, thf, self.size)

    def render(self, cam_t, fov_rad: Optional[float] = None) -> np.ndarray:
        """The (canvas_size, canvas_size, 3) uint8 frame."""
        from depthmap_tpu_torch.ops.filters import cv2_gaussian_blur_u8
        from depthmap_tpu_torch.ops.resize import cv2_resize_area_u8
        img = (self.render_device(cam_t, fov_rad).clamp(0, 1) * 255).to(
            torch.uint8).cpu().numpy()
        k = int(self.ssaa // 2 * 2 + 1)
        if k > 1:
            img = cv2_gaussian_blur_u8(img, k)
        out_size = self.size // self.ssaa
        return cv2_resize_area_u8(img, (out_size, out_size))
