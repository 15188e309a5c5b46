"""Kernel K2: the polylines stereo rasterizer (the default fill).

``polylines_rasterize`` launches the hand-written CUDA kernel of
``csrc/polylines.cu`` (the port of the Pallas TPU kernel
depthmap_tpu/ops/polylines_pallas.py:451) for CUDA tensors and runs the
host kernel of ``csrc/polylines_host.cpp`` (built by g++ at first use,
``ops/host_build.py``) for CPU tensors.  Both follow the f64
sort-and-sweep of depthmap_tpu/native/polylines.cpp:26 and are byte-exact
against it and against ``polylines_plain``, the function in plain torch,
which the tests hold them to.
"""
from __future__ import annotations

import ctypes

import torch

from depthmap_tpu_torch.ops import cuda_build, host_build

EPS = 1e-7
_MAX_CHANNELS = 4


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


def _lib():
    lib = cuda_build.load("polylines", extra_flags=("-fmad=false",))
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        ci, cd = ctypes.c_int, ctypes.c_double
        lib.polylines_sort_scratch_bytes.argtypes = [ci, ci]
        lib.polylines_sort_scratch_bytes.restype = ctypes.c_longlong
        lib.polylines_spill_slots.argtypes = [ci, ci]
        lib.polylines_spill_slots.restype = ci
        lib.polylines_sort_forward.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                               ci, ci, cd, cd, ci, vp]
        lib.polylines_sort_forward.restype = ci
        lib.polylines_sweep_forward.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                                ci, ci, ci, vp]
        lib.polylines_sweep_forward.restype = ci
        lib.polylines_error_string.argtypes = [ci]
        lib.polylines_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError("polylines kernel: "
                           + lib.polylines_error_string(err).decode())


def _sort_cuda(image: torch.Tensor, nd: torch.Tensor, divergence_px: float,
               separation_px: float, exponent: float, sharp: bool):
    """Stage A of the kernel: image (R, W, C) uint8 and nd (R, W) float64 on
    the card -> the segments in stable order of their start x: sorted
    (5, R, stride) f64 (start x, end x, closeness at start and end,
    1 / (end x - start x); sorted[0][:, n_seg] is the last point, 2W), rgb
    (R, stride) int64 (the start and end columns' colours, channel ch in
    byte ch and byte 4 + ch) and order (R, stride) int32 (the start point);
    n_seg = 2W + 1 sharp, W + 1 soft."""
    rows, w, ch = image.shape
    # nd^exponent by the plain version's own operation
    ep = nd if exponent == 1.0 else nd.pow(exponent).contiguous()
    n_seg = 2 * w + 1 if sharp else w + 1
    stride = (n_seg + 1 + 31) // 32 * 32
    dev = nd.device
    lib = _lib()
    sorted_ = torch.empty((5, rows, stride), dtype=torch.float64, device=dev)
    rgb = torch.empty((rows, stride), dtype=torch.int64, device=dev)
    order = torch.empty((rows, stride), dtype=torch.int32, device=dev)
    per_row = lib.polylines_sort_scratch_bytes(w, int(bool(sharp)))
    scratch = torch.empty(rows * per_row, dtype=torch.uint8, device=dev) \
        if per_row else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib, lib.polylines_sort_forward(
            image.data_ptr(), ep.data_ptr(), sorted_.data_ptr(),
            rgb.data_ptr(), order.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, rows, w, ch,
            stride, float(divergence_px), float(separation_px),
            int(bool(sharp)), stream))
    _sort_cuda.launches += 1
    return sorted_, rgb, order


_sort_cuda.launches = 0


def _sweep_cuda(sorted_: torch.Tensor, rgb: torch.Tensor,
                order: torch.Tensor, w: int, ch: int,
                sharp: bool) -> torch.Tensor:
    """Stage B of the kernel on stage A's arrays -> the eye (R, W, C)
    uint8.  Its spill area has room for every segment of a row on the
    active list, so no input outgrows it (a smaller one sized from a
    bound needs an overflow check and a host sync per call; PERF.md has
    what that cost)."""
    rows, stride = order.shape
    dev = order.device
    lib = _lib()
    spill = lib.polylines_spill_slots(w, int(bool(sharp)))
    # a spilled slot is 7 words (Seg in csrc/polylines.cu)
    spill_words = torch.empty((rows, 7, spill), dtype=torch.int64,
                              device=dev)
    out = torch.empty((rows, w, ch), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib, lib.polylines_sweep_forward(
            out.data_ptr(), sorted_.data_ptr(), rgb.data_ptr(),
            order.data_ptr(), spill_words.data_ptr(), rows, w, ch, stride,
            spill, int(bool(sharp)), stream))
    _sweep_cuda.launches += 1
    return out


_sweep_cuda.launches = 0


def polylines_cuda(image: torch.Tensor, nd: torch.Tensor,
                   divergence_px: float, separation_px: float,
                   exponent: float, sharp: bool) -> torch.Tensor:
    """Launch the CUDA kernel: image (R, W, C) uint8 and nd (R, W) float64,
    contiguous, on one CUDA device; every row in one launch of each stage
    (the sort, then the sweep), each stage counting its own launches."""
    if not (image.is_cuda and nd.is_cuda) or image.device != nd.device:
        raise ValueError("polylines_cuda needs image and nd on one CUDA "
                         "device")
    if image.dtype != torch.uint8 or nd.dtype != torch.float64:
        raise TypeError(f"dtypes {image.dtype}, {nd.dtype}: the kernel takes "
                        "uint8 image and float64 nd")
    if image.dim() != 3 or nd.dim() != 2 or \
            tuple(image.shape[:2]) != tuple(nd.shape) or \
            not 1 <= image.shape[2] <= _MAX_CHANNELS:
        raise ValueError(f"shapes image {tuple(image.shape)} nd "
                         f"{tuple(nd.shape)}: need (R, W, 1..4) and (R, W)")
    if not (image.is_contiguous() and nd.is_contiguous()):
        raise ValueError("polylines_cuda needs contiguous inputs")
    _, w, ch = image.shape
    _check_span(w, divergence_px, separation_px)
    sorted_, rgb, order = _sort_cuda(image, nd, divergence_px, separation_px,
                                     exponent, sharp)
    return _sweep_cuda(sorted_, rgb, order, w, ch, sharp)


def _host_lib():
    lib = host_build.load("polylines_host")
    if not getattr(lib, "_typed", False):
        lib.polylines.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_void_p]
        lib.polylines.restype = None
        lib._typed = True
    return lib


def polylines_host(image: torch.Tensor, nd: torch.Tensor,
                   divergence_px: float, separation_px: float,
                   exponent: float, sharp: bool) -> torch.Tensor:
    """Run the host kernel: image (R, W, C) uint8 and nd (R, W) float64,
    contiguous, on the CPU; the rows on a thread each of the host's
    cores.  Counts its calls in ``polylines_host.launches``."""
    if image.is_cuda or nd.is_cuda:
        raise ValueError("polylines_host takes CPU tensors")
    if image.dtype != torch.uint8 or nd.dtype != torch.float64:
        raise TypeError(f"dtypes {image.dtype}, {nd.dtype}: the kernel takes "
                        "uint8 image and float64 nd")
    if image.dim() != 3 or nd.dim() != 2 or \
            tuple(image.shape[:2]) != tuple(nd.shape) or \
            not (image.is_contiguous() and nd.is_contiguous()):
        raise ValueError(f"shapes image {tuple(image.shape)} nd "
                         f"{tuple(nd.shape)}: need contiguous (R, W, C) "
                         "and (R, W)")
    rows, w, ch = image.shape
    _check_span(w, divergence_px, separation_px)
    out = torch.empty_like(image)
    _host_lib().polylines(image.data_ptr(), nd.data_ptr(), rows, w, ch,
                          float(divergence_px), float(separation_px),
                          float(exponent), int(bool(sharp)), out.data_ptr())
    polylines_host.launches += 1
    return out


polylines_host.launches = 0


def polylines_rasterize(image: torch.Tensor, nd: torch.Tensor,
                        divergence_px: float, separation_px: float,
                        exponent: float, sharp: bool) -> torch.Tensor:
    """image (..., H, W, C) uint8, nd (..., H, W) normalized depth in [0, 1]
    -> (..., H, W, C) uint8.  Leading dims (frames) flatten into rows of
    one launch.  CUDA tensors launch the kernel, CPU tensors the host
    kernel."""
    lead = image.shape[:-2]
    w, ch = image.shape[-2:]
    img2 = image.reshape(-1, w, ch).contiguous()
    nd2 = nd.reshape(-1, w).to(torch.float64).contiguous()
    if image.is_cuda:
        out = polylines_cuda(img2, nd2, divergence_px, separation_px,
                             exponent, sharp)
    else:
        out = polylines_host(img2, nd2, divergence_px, separation_px,
                             exponent, sharp)
    return out.reshape(*lead, w, ch)
