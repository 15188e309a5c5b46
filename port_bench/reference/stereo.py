"""The stereo pair of the polylines fills, in plain PyTorch, in f64.

The sort-and-sweep rasterizer of MiDaS-era stereo-image-generation's
polylines fill (the f64 host algorithm: each row's points at
x + 0.5 + d^e * divergence + separation, two per pixel for the sharp
fill, sentinels at -w and 2w; segments in stable order of their start;
each output pixel the sum over its sub-pixel parts of the closest
segment's colour, interpolated, times the part's width), frozen here from
the program's plain version as it stood when the benchmark was written, so
that later changes to the program do not move the yardstick.  It is
vectorized over rows and exact to the byte against the f64 host
algorithm.  ``eyes`` adds the funnel's normalization of the uint16 map,
the divergence in pixels and the two compositions.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

EPS = 1e-7


def _check_span(w: int, divergence_px: float, separation_px: float) -> None:
    """The sentinels at -w and 2w must bound every morphed point."""
    if abs(divergence_px) + abs(separation_px) >= w:
        raise ValueError(f"|divergence| + |separation| = "
                         f"{abs(divergence_px) + abs(separation_px)} px "
                         f"reaches the row width {w}")


def _points(nd: torch.Tensor, w: int, divergence_px: float,
            separation_px: float, exponent: float, sharp: bool):
    """Polyline points of every row in polyline order: x (R, P) and the
    closeness |d| (R, P) in f64, and the source column (P,)."""
    r = nd.shape[0]
    dev = nd.device
    f64 = torch.float64
    ndd = nd.to(f64)
    e = ndd if exponent == 1.0 else ndd.pow(exponent)
    coord_d = e * divergence_px
    cols = torch.arange(w, dtype=f64, device=dev)
    coord_x = cols + 0.5 + coord_d + separation_px
    absd = coord_d.abs()
    colsi = torch.arange(w, device=dev)
    if sharp:
        x = torch.stack([coord_x - 0.45, coord_x + 0.45], -1).reshape(r, 2 * w)
        d = absd.repeat_interleave(2, dim=1)
        c = colsi.repeat_interleave(2)
    else:
        x, d, c = coord_x, absd, colsi
    px = torch.cat([torch.full((r, 1), -1.0 * w, dtype=f64, device=dev), x,
                    torch.full((r, 1), 2.0 * w, dtype=f64, device=dev)], 1)
    pd = torch.cat([torch.zeros((r, 1), dtype=f64, device=dev), d,
                    torch.zeros((r, 1), dtype=f64, device=dev)], 1)
    pc = torch.cat([torch.zeros(1, dtype=c.dtype, device=dev), c,
                    torch.full((1,), w - 1, dtype=c.dtype, device=dev)])
    return px, pd, pc


def _compact(active: torch.Tensor, alive: torch.Tensor):
    """The host kernel's removal loop (for i: if dead, active[i] =
    active.back(); pop) in closed form: alive entries below the new length
    m stay; the k-th dead slot below m takes the k-th alive entry counted
    from the end.  active, alive: (R, CAP); returns (active, m)."""
    cap = active.shape[1]
    slot = torch.arange(cap, device=active.device)
    m = alive.sum(1, keepdim=True)
    front = slot < m
    hole = front & ~alive
    back = ~front & alive
    hole_rank = torch.cumsum(hole.to(torch.int64), 1) - 1
    back_rank = torch.cumsum(back.flip(1).to(torch.int64), 1).flip(1) - 1
    src = torch.zeros((active.shape[0], cap + 1), dtype=active.dtype,
                      device=active.device)
    src.scatter_(1, torch.where(back, back_rank, cap), active)
    filled = src.gather(1, torch.where(hole, hole_rank, 0))
    return torch.where(hole, filled, active), m[:, 0]


def polylines_plain(image: torch.Tensor, nd: torch.Tensor,
                    divergence_px: float, separation_px: float,
                    exponent: float, sharp: bool) -> torch.Tensor:
    """The kernel's function in plain torch, vectorized over rows.

    image (R, W, C) uint8, nd (R, W) float -> (R, W, C) uint8.  Everything
    that does not depend on the active-segment list (sorting, the sub-pixel
    parts, their centres and the insertion pointer) is computed for all
    steps at once; the sweep then steps through the parts in order for
    every row together, so each row sees the host kernel's exact sequence
    of f64 operations."""
    rows, w, ch = image.shape
    _check_span(w, divergence_px, separation_px)
    dev = image.device
    f64 = torch.float64
    px, pd, pc = _points(nd, w, divergence_px, separation_px, exponent,
                         sharp)
    n_pt = px.shape[1]
    s_end = n_pt - 1
    sx0, order = torch.sort(px[:, :s_end], dim=1, stable=True)
    sx1 = px.gather(1, order + 1)
    sd0 = pd.gather(1, order)
    sd1 = pd.gather(1, order + 1)
    sc0 = pc[order]
    sc1 = pc[order + 1]
    pts = torch.cat([sx0, px[:, s_end:]], 1)

    # the sub-pixel parts: for output column col, sorted points j from
    # (first point >= col) - 1 up to the last point < col + 1
    edges = torch.arange(w + 1, dtype=f64, device=dev).expand(rows, w + 1)
    first = torch.searchsorted(pts, edges.contiguous(), side="left")
    cnt = first[:, 1:] - first[:, :-1] + 1
    csum = torch.cumsum(cnt, 1)
    n_steps = csum[:, -1]
    t_max = int(n_steps.max())
    t = torch.arange(t_max, device=dev).expand(rows, t_max).contiguous()
    col_t = torch.searchsorted(csum, t, side="right").clamp(max=w - 1)
    valid = t < n_steps[:, None]
    j = (first[:, :-1] - 1).gather(1, col_t) + \
        (t - (csum - cnt).gather(1, col_t))
    j = j.clamp(0, n_pt - 2)
    a = pts.gather(1, j)
    bnext = pts.gather(1, j + 1)
    colf = col_t.to(f64)
    cf = torch.where(colf < a, a, colf) + EPS
    top = colf + 1
    ct = torch.where(bnext < top, bnext, top) - EPS
    sig = ct - cf
    xc = cf + 0.5 * sig
    xc = torch.where(valid, xc, torch.full_like(xc, float("-inf")))
    ptr = torch.cummax(torch.searchsorted(sx0, xc, side="left"), 1).values
    ptr_prev = torch.cat([torch.zeros_like(ptr[:, :1]), ptr[:, :-1]], 1)
    k = ptr - ptr_prev
    kmax = max(int(k.max()), 1)

    img = image.to(f64)
    ar_k = torch.arange(kmax, device=dev)
    ridx = torch.arange(rows, device=dev)
    cap = kmax + 4 * int(abs(divergence_px) + abs(separation_px)) + 64
    while True:
        slot = torch.arange(cap, device=dev)
        active = torch.zeros((rows, cap + 1), dtype=torch.int64, device=dev)
        n_act = torch.zeros(rows, dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        acc = torch.full((rows, w, ch), 0.5, dtype=f64, device=dev)
        for step in range(t_max):
            xc_t = xc[:, step:step + 1]
            # push the segments whose start lies before the part's centre
            ok = ar_k < k[:, step:step + 1]
            pos = torch.where(ok, n_act[:, None] + ar_k, cap).clamp(max=cap)
            active.scatter_(1, pos, ptr_prev[:, step:step + 1] + ar_k)
            n_act = n_act + k[:, step]
            overflow |= (n_act > cap).any()
            seg = active[:, :cap]
            segc = seg.clamp(0, s_end - 1)
            alive = (slot < n_act[:, None]) & ~(sx1.gather(1, segc) < xc_t)
            seg, n_act = _compact(seg, alive)
            active[:, :cap] = seg
            # the closest segment: first maximum of the closeness among
            # those the part's centre lies strictly inside
            segc = seg.clamp(0, s_end - 1)
            x0 = sx0.gather(1, segc)
            x1 = sx1.gather(1, segc)
            ip = (xc_t - x0) / (x1 - x0)
            cl = (1.0 - ip) * sd0.gather(1, segc) + ip * sd1.gather(1, segc)
            cand = (slot < n_act[:, None]) & (cl > -EPS) & (0.0 < ip) & \
                (ip < 1.0)
            score = torch.where(cand, cl, torch.full_like(cl, float("-inf")))
            top_score = score.amax(1, keepdim=True)
            first_best = torch.where(cand & (score == top_score), slot,
                                     cap).amin(1)
            best_slot = torch.where((n_act != 1) & cand.any(1), first_best,
                                    0)
            best = seg.gather(1, best_slot[:, None]).clamp(0, s_end - 1)
            bx0 = sx0.gather(1, best)
            bx1 = sx1.gather(1, best)
            c0 = sc0.gather(1, best)[:, 0]
            c1 = sc1.gather(1, best)[:, 0]
            il = img[ridx, c0]
            ir = img[ridx, c1]
            sig_t = sig[:, step:step + 1]
            ipb = (xc_t - bx0) / (bx1 - bx0)
            contrib = torch.where((c0 == c1)[:, None], il * sig_t,
                                  (il * (1.0 - ipb) + ir * ipb) * sig_t)
            use = valid[:, step] & (n_act > 0)
            contrib = torch.where(use[:, None], contrib,
                                  torch.zeros_like(contrib))
            cols_t = col_t[:, step]
            acc[ridx, cols_t] = acc[ridx, cols_t] + contrib
        if not bool(overflow):
            break
        cap *= 4
    return torch.clamp(acc, 0.0, 255.0).to(torch.uint8)


def normalize(depth16: np.ndarray) -> torch.Tensor:
    """(depth - min) / (max - min) of the uint16 map, in f32."""
    d = torch.as_tensor(depth16.astype(np.float32))
    return (d - d.min()) / (d.max() - d.min())


def eye_rows(image: np.ndarray, depth16: np.ndarray, rows: Sequence[int],
             divergence: float, separation: float, exponent: float,
             balance: float, sharp: bool) -> Dict[str, np.ndarray]:
    """The left and right eye of ``rows`` of one photo (uint8 (H, W, 3),
    its uint16 map), as the stereo options give them: left at +divergence
    x balance' and -separation, right at -divergence x (1 - balance') and
    +separation, balance' = (balance + 1) / 2, each in percent of the
    width."""
    w = image.shape[1]
    nd = normalize(depth16)[list(rows)].to(torch.float64)
    img = torch.as_tensor(np.ascontiguousarray(image[list(rows)]))
    bal = (balance + 1) / 2
    left = polylines_plain(img, nd, (divergence * bal / 100.0) * w,
                           (-1 * separation / 100.0) * w, exponent, sharp)
    right = polylines_plain(img, nd, (-divergence * (1 - bal) / 100.0) * w,
                            (separation / 100.0) * w, exponent, sharp)
    return {"left": left.numpy(), "right": right.numpy()}


def compose(mode: str, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """One stereo output from the two eyes (rows of them)."""
    if mode == "left-right":
        return np.concatenate([left, right], axis=-2)
    if mode == "right-left":
        return np.concatenate([right, left], axis=-2)
    if mode == "red-cyan-anaglyph":
        return np.stack([left[..., 0], right[..., 1], right[..., 2]], -1)
    if mode == "cyan-red-reverseanaglyph":
        return np.stack([right[..., 0], left[..., 1], left[..., 2]], -1)
    if mode == "left-only":
        return left
    if mode == "only-right":
        return right
    raise ValueError(f"stereo mode {mode!r} is not compared by rows")
