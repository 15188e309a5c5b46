#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one CUDA card.

    python3 chip_smoke.py             # the smoke test
    python3 chip_smoke.py --profile   # and a device-time breakdown

Phases (each prints one line with its numbers; any failure exits non-zero
and prints no result):
  0. environment: CUDA required; torch / CUDA versions, the card's name
     and power limit from nvidia-smi, whether PIL and cv2 import;
  1. build: nvcc builds both hand-written kernels from csrc/ (in
     parallel); ptxas's register / spill report of each kernel; the count
     of HGMMA (wgmma) instructions in K1's SASS, which must not be 0;
  2. K1 (flash attention) against its plain version at the model paths'
     shapes, bf16 (tensor-core body) and f32 (CUDA-core body), with a
     padded-row bias (BEiT) and without (Depth Anything: 12 and 16 heads,
     N up to 10765; the MiDaS 3.0 ViTs at N = 577, where the last kv tile
     holds one key, and 1009), on inputs that peak the softmax
     (K1_Q_SCALE); per case the kernel's time (CUDA events over 20 calls;
     and its device time from torch.profiler, which leaves out the host's
     launch gaps that the events hold at the short shapes), the plain
     version's, SDPA's on the same tensors, both ways (the efficient
     backend, and the flash backend where it runs: bf16, no mask; the
     port never calls either), the bound and the share of it, and the
     error of three planted faults (a kv tile skipped, the output
     scaled), each of which must exceed the bound;
  3. K2 (polylines) against its plain version, byte-exact: at 1080x1920,
     8 cases on a random depth map (the timed one: sharp, +-24 px) and one
     timed case on a smooth map, like the main path's; at 512x512 (the
     main path's other eyes), sharp at its +-6.4 px, random and smooth;
     each stage's time (the sort, the sweep), the sweep's steps per row
     and its time per step, and the bound;
  4. main path, MAIN_RUNS timed runs: dpt_beit_large_512 at full width
     (24 blocks, 1024 wide, random init from a seed, bf16) through
     PredictorCache and core_generation_funnel: 4 images of 512x512
     (batched pre-pass) and one of 1920x1080 (serial path, inline
     per-block bias, table resize), with
     depth, left-right and red-cyan-anaglyph outputs; the kernels' launch
     counts (K2: its sort and its sweep, one of each per eye) must show the
     path ran through them;
  5. whole-path numerics: one image through the predictor in f32 on the
     card (kernels, TF32 off) and on the CPU (plain versions):
     dpt_beit_large_512 at 512x512, Depth Anything v2 Base at 518x518,
     dpt_large_384 and dpt_hybrid_384 at 384x384, midas_v21 at 384x384 and
     midas_v21_small at 256x256;
  6. the default options' path, MAIN_RUNS timed runs: GenerationOptions()
     (Depth Anything v2 Base, net 448, 12 blocks, 768 wide, 12 heads,
     bf16) with naive-fill stereo, on the images of phase 4: K1 bias-free
     at N = 1025 (batched) and 1825 (serial), 12 launches per forward;
  7. long N, 2 timed runs: Depth Anything v2 Large (24 blocks, 1024 wide)
     with net_size_match on one 1920x1080 image, depth only: N = 10765,
     24 K1 launches;
  8. the warp stereo fills (none, naive, naive_interpolating) at
     1080x1920, exponent 1 and 1.7, card against CPU byte for byte, ms
     per eye beside K2's;
  9. this slice's path, MAIN_RUNS timed runs: dpt_large_384 at full width
     (ViT-L/16: 24 blocks, 1024 wide, 16 heads, bf16) on the images of
     phase 4 at net 384 with depth, normal map and heatmap: K1 at N = 577
     (4 x 512^2, batched) and 1009 (1080p, serial), 24 launches a forward;
     then one 512^2 image with the simple mesh (its OBJ must hold 512^2
     vertices);
 10. the rest of the zoo on the same images and outputs, 2 timed runs
     each: dpt_hybrid_384 (ResNet-50 + ViT-B/16, 12 K1 launches a
     forward), midas_v21 and midas_v21_small (conv nets: 0 launches);
 11. the normal map at 1080x1920 on the maps of phase 8, every option
     (pre-blur, Sobel kernel or np.gradient, post-blur, invert), card
     against CPU within |d| <= 1 on <= 0.1% of the bytes, ms per map;
     the heatmap's host time on the same maps.
Each model path (4, 6, 7, 9, 10) sets every kernel count to 0 just before
each timed run and reads it just after.  With --profile, torch.profiler
over one warm funnel run per path gives each path's device time and K1's
/ K2's share of it (K2: both stages).  The last lines: the card's name and power
limit, a JSON line with each kernel's numbers (K1's launches: the sum over
phases 4, 6, 7, 9 and 10, each path's count beside it; K2's: phase 4's
sweeps),
and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# K1 bounds against the plain version (max abs error).  f32: the bound the
# JAX package holds its TPU kernel to.  bf16: the output is rounded to
# bf16 (one ulp is 2^-8 relative, 7.8e-3 at |x| in [1, 2)) and p is
# rounded to bf16 before p.v, so a different f32 summation order can flip
# one rounding of each; 2e-2 is about two output ulps at the largest
# outputs of these inputs.
K1_BOUND = {"float32": 5e-3, "bfloat16": 2e-2}
# K1's inputs: q ~ 4 N(0, 1), k ~ N(0, 1), v ~ N(0, 1) / 4.  The logits
# (D = 64, scale 1/8) have std 4, so the softmax is peaked and an output
# is a mix of a few values of v (at most ~1.4), far above the bound where
# a kernel errs.  With std-1 logits the softmax is nearly flat and the
# outputs' RMS is sqrt(e / Nk), 0.016 at Nk = 10765: under the bf16 bound.
K1_Q_SCALE, K1_V_SCALE = 4.0, 0.25
K1_SOURCE = "depthmap_tpu_torch/csrc/flash_attention.cu"
K1_REPLACES = "depthmap_tpu/ops/flash_attention.py:250"
K2_SOURCE = "depthmap_tpu_torch/csrc/polylines.cu"
K2_REPLACES = "depthmap_tpu/ops/polylines_pallas.py:389"
# whole-path f32 agreement, card (kernels) vs CPU (plain versions), as a
# fraction of the CPU map's range
PATH_RTOL = 1e-3
# timed runs of the main path (each resets and checks the launch counts),
# for the spread of its host-clock times
MAIN_RUNS = 3
# One H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): memory
# bytes/s, bf16 tensor-core and f32 CUDA-core flop/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound(nbytes: float, flops: float, dtype: str = "bfloat16"):
    """(ms, basis): the least time for moving nbytes and doing flops."""
    mem = nbytes / HBM_BPS * 1e3
    ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """The device time of one call of ``fn``: its kernels' times summed by
    torch.profiler over ``iters`` calls (after a warm one), per call.  A
    short kernel's CUDA-event time (``cuda_ms``) holds the host's launch
    gaps too when the host takes longer per call than the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if t is None else t
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return total / 1e3 / iters


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the port's "
                           "smoke test needs a CUDA card")
    import depthmap_tpu_torch  # noqa: F401  (fails outside the repo)
    have = {}
    for mod in ("PIL", "cv2"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    smi = smi_line()
    log("0-env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), smi=repr(smi),
        PIL=have["PIL"], cv2=have["cv2"])
    return smi


def phase_build():
    from depthmap_tpu_torch.ops import cuda_build
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda f: f(), (fa._lib, pl._lib)))
    log("1-build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_kernel={k: round(v, 2) for k, v in
                    cuda_build.build_seconds.items()})
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("1-ptxas", lib=name, info=repr(line.strip()))
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", libs[0]._name],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    hgmma = sass.count("HGMMA")
    log("1-sass", lib="flash_attention", HGMMA=hgmma)
    if hgmma == 0:
        raise AssertionError("no HGMMA instruction in K1's SASS: the bf16 "
                             "body does not run on the tensor cores")


def k1_bound(b, h, n, nk, bias_batch, dtype):
    """K1's bound: q, k, v, out and the bias's N x Nk entries moved once;
    4.B.H.N.Nk.D flops."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (b * h * (2 * n + 2 * nk) * 64
                     + (bias_batch or 0) * h * n * nk)
    return bound(nbytes, 4.0 * b * h * n * nk * 64, dtype)


def k1_fault_errors(q, k, v, bias, want):
    """What the K1 check sees of a faulty kernel: the max abs error against
    ``want`` of the answer a kernel with each fault would give, made by the
    plain version on the same inputs.  Faults: the last kv tile of 64 keys
    skipped (the ragged one where Nk % 64 != 0), the first one skipped, the
    output scaled by 0.8.  Each must exceed the case's bound."""
    from depthmap_tpu_torch.ops import flash_attention as fa
    nk = k.shape[2]

    def without(keep):
        b = bias[..., keep] if bias is not None else None
        return fa.flash_attention_plain(q, k[:, :, keep], v[:, :, keep], b)
    faults = {"x0.8": lambda: want.float() * 0.8}
    if nk > 64:
        faults["last_kv_tile"] = lambda: without(slice(0, nk - (nk % 64
                                                                or 64)))
        faults["first_kv_tile"] = lambda: without(slice(64, nk))
    return {name: (f().float() - want.float()).abs().max().item()
            for name, f in faults.items()}


def phase_k1():
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from depthmap_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, dtype, B, H, N, bias batch or None); the first two
        # are the BEiT path's bf16 calls, f32_b1_n1025_shared its f32 call of
        # phase 5; every bias is in the padded-row layout.  The bias-free
        # h6/h12/h16 cases are Depth Anything's calls: v2 Base at 512^2
        # (net 448, N = 1025) and 1080p (N = 1825), its f32 call at 518^2
        # (N = 1370), v2 Large at 518^2 and at 1080p with net_size_match
        # (N = 10765, bound by operations)
        ("bf16_b4_h16_n1025_shared", bf16, 4, 16, 1025, 1),
        ("bf16_b1_h16_n1793_shared", bf16, 1, 16, 1793, 1),
        ("bf16_b2_h16_n1025_shared", bf16, 2, 16, 1025, 1),
        ("bf16_b2_h16_n1025_none", bf16, 2, 16, 1025, None),
        ("f32_b1_h16_n1025_shared", f32, 1, 16, 1025, 1),
        ("f32_b2_h16_n130_batched", f32, 2, 16, 130, 2),
        ("f32_b2_h16_n130_none", f32, 2, 16, 130, None),
        ("f32_b2_h16_n513_batched", f32, 2, 16, 513, 2),
        ("f32_b2_h16_n513_none", f32, 2, 16, 513, None),
        ("bf16_b4_h12_n1025_none", bf16, 4, 12, 1025, None),
        ("bf16_b1_h12_n1825_none", bf16, 1, 12, 1825, None),
        ("bf16_b1_h16_n1370_none", bf16, 1, 16, 1370, None),
        ("bf16_b1_h16_n10765_none", bf16, 1, 16, 10765, None),
        ("f32_b1_h12_n1370_none", f32, 1, 12, 1370, None),
        # MiDaS 3.0: ViT-L (16 heads) and the hybrid's ViT-B (12) at 512^2
        # on net 384 (a 24 x 24 grid: N = 577, one key in the last kv
        # tile) and at 1080p (672 x 384: 42 x 24, N = 1009); BEiT-384's
        # biased call at N = 577 (rows padded to 592)
        ("bf16_b4_h16_n577_none", bf16, 4, 16, 577, None),
        ("bf16_b1_h16_n1009_none", bf16, 1, 16, 1009, None),
        ("bf16_b4_h12_n577_none", bf16, 4, 12, 577, None),
        ("bf16_b1_h12_n1009_none", bf16, 1, 12, 1009, None),
        ("bf16_b1_h16_n577_shared", bf16, 1, 16, 577, 1),
    ]
    worst = 0.0
    main = None
    for name, dt, b, h, n, bb in cases:
        def mk(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to("cuda", dt)
        q = mk(b, h, n, 64, scale=K1_Q_SCALE)
        k, v = mk(b, h, n, 64), mk(b, h, n, 64, scale=K1_V_SCALE)
        bias = fa.pad_bias_rows(mk(bb, h, n, n)) if bb else None
        got = fa.flash_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, bias)
        err = (got.float() - want.float()).abs().max().item()
        dts = str(dt).split(".")[-1]
        tol = K1_BOUND[dts]
        faults = k1_fault_errors(q, k, v, bias, want)
        del want
        torch.cuda.empty_cache()
        def k1_call():
            return fa.flash_attention_cuda(q, k, v, bias)
        ms = cuda_ms(k1_call, 20)
        dev_ms = device_ms(k1_call, 10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                           3)
        # SDPA on the same tensors: the efficient backend takes the
        # padded-row mask; the flash backend takes no mask and no f32
        library, library_dev = {}, {}
        backends = [("efficient", SDPBackend.EFFICIENT_ATTENTION)]
        if bias is None and dt == bf16:
            backends.append(("flash", SDPBackend.FLASH_ATTENTION))
        for lib, backend in backends:
            def sdpa_call():
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=bias)
            library[lib] = cuda_ms(sdpa_call, 20)
            library_dev[lib] = device_ms(sdpa_call, 10)
        bound_ms, basis = k1_bound(b, h, n, n, bb, dts)
        log("2-k1", case=name, max_abs_err=f"{err:.3e}", tol=tol,
            ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}",
            **{f"sdpa_{lib}_ms": f"{t:.4f}" for lib, t in library.items()},
            **{f"sdpa_{lib}_device_ms": f"{t:.4f}"
               for lib, t in library_dev.items()},
            bound_us=f"{bound_ms * 1e3:.1f}", bound_by=basis,
            share_of_bound=f"{bound_ms / ms:.3f}",
            device_share_of_bound=f"{bound_ms / dev_ms:.3f}",
            **{f"fault_{f}_err": f"{e:.3e}" for f, e in faults.items()})
        if not err <= tol:
            raise AssertionError(f"K1 {name}: max abs err {err} > {tol}")
        if not min(faults.values()) > tol:
            raise AssertionError(f"K1 {name}: a faulty kernel would pass "
                                 f"the bound {tol}: {faults}")
        worst = max(worst, err)
        if main is None:
            main = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                        library_ms=library["efficient"], bound_ms=bound_ms,
                        bound_by=basis)
        del q, k, v, bias, got
        torch.cuda.empty_cache()
    return worst, main


def k2_stages(img, nd, div, sharp):
    """K2's two stages timed apart, and the sweep's steps: (sort_ms,
    sweep_ms, max steps of a row, mean steps)."""
    import torch
    from depthmap_tpu_torch.ops import polylines as pl
    rows, w, ch = img.shape
    sorted_, rgb, order = pl._sort_cuda(img, nd, div, 0.0, 1.0, sharp)
    sort_ms = cuda_ms(lambda: pl._sort_cuda(img, nd, div, 0.0, 1.0, sharp),
                      5)
    sweep_ms = cuda_ms(lambda: pl._sweep_cuda(sorted_, rgb, order, w, ch,
                                              sharp), 5)
    # a row's parts: for each column, the sorted points from the last one
    # below it to the last one below the next column
    n_seg = 2 * w + 1 if sharp else w + 1
    pts = sorted_[0, :, :n_seg + 1].contiguous()
    edges = torch.tensor([0.0, float(w)], dtype=torch.float64,
                         device=pts.device).expand(rows, 2).contiguous()
    lo = torch.searchsorted(pts, edges)
    steps = (lo[:, 1] - lo[:, 0] + w).double()
    return sort_ms, sweep_ms, int(steps.max()), float(steps.mean())


def k2_inputs(g, rows, w):
    """An image, a random depth map and a smooth one (like the main
    path's), on the card."""
    import torch
    img = torch.randint(0, 256, (rows, w, 3), generator=g,
                        dtype=torch.uint8).cuda()
    nd = torch.rand((rows, w), generator=g, dtype=torch.float64).cuda()
    yy, xx = torch.meshgrid(torch.arange(rows, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    smooth = (0.5 + 0.5 * torch.sin(xx / 97.0) * torch.cos(yy / 61.0)).cuda()
    return img, {"random": nd, "smooth": smooth}


def phase_k2():
    import torch
    from depthmap_tpu_torch.ops import polylines as pl
    g = torch.Generator(device="cpu").manual_seed(2)
    inputs = {1080: k2_inputs(g, 1080, 1920), 512: k2_inputs(g, 512, 512)}
    timed = []
    worst = 0
    # one eye: the image and the f64 map read once, the eye written once
    bounds = {rows: bound(img.shape[0] * img.shape[1] * (3 + 8 + 3), 0.0)
              for rows, (img, _) in inputs.items()}
    bound_ms, basis = bounds[1080]
    log("3-k2", bound_us_1080p=f"{bound_ms * 1e3:.2f}",
        bound_us_512=f"{bounds[512][0] * 1e3:.2f}", bound_by=basis)
    # (rows, depth, sharp, divergence px); the main path's eyes are sharp,
    # at +-2.5% / 2 of the width: +-24 px at 1080p, +-6.4 px at 512^2.  The
    # first case of each (rows, depth) is timed by stage.
    cases = [(1080, "random", sharp, div) for sharp in (True, False)
             for div in (24.0, -24.0, 48.0, -48.0)] + \
        [(1080, "smooth", True, 24.0)] + \
        [(512, depth, True, div) for depth in ("random", "smooth")
         for div in (6.4, -6.4)]
    staged = set()
    for rows, depth, sharp, div in cases:
        img, maps = inputs[rows]
        m = maps[depth]
        got = pl.polylines_cuda(img, m, div, 0.0, 1.0, sharp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pl.polylines_plain(img, m, div, 0.0, 1.0, sharp)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ndiff = int((got != want).sum())
        worst = max(worst, int((got.int() - want.int()).abs().max()))
        ms = cuda_ms(lambda: pl.polylines_cuda(img, m, div, 0.0, 1.0,
                                               sharp), 5)
        extra = {}
        if (rows, depth) not in staged:
            staged.add((rows, depth))
            sort_ms, sweep_ms, steps, mean = k2_stages(img, m, div, sharp)
            extra = dict(sort_ms=f"{sort_ms:.4f}", sweep_ms=f"{sweep_ms:.4f}",
                         steps_max=steps, steps_mean=f"{mean:.1f}",
                         sweep_ns_per_step=f"{sweep_ms * 1e6 / steps:.1f}",
                         share_of_bound=f"{bounds[rows][0] / ms:.5f}")
        log("3-k2", shape=f"{rows}x{img.shape[1]}", depth=depth, sharp=sharp,
            divergence_px=div, bytes_differ=ndiff, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.1f}", **extra)
        if ndiff:
            raise AssertionError(f"K2 {rows} {depth} sharp={sharp} div={div}:"
                                 f" {ndiff} bytes differ from the plain "
                                 "version")
        if rows == 1080 and depth == "random" and sharp and abs(div) == 24.0:
            timed.append((ms, plain_ms))
    return worst, dict(ms=sum(t[0] for t in timed) / len(timed),
                       plain_ms=sum(t[1] for t in timed) / len(timed),
                       library_ms=None, bound_ms=bound_ms, bound_by=basis)


def _test_images(seed: int, shapes):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for h, w in shapes:
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        base = np.stack([np.sin(6 * xx + c) * np.cos(4 * yy - c)
                         for c in (0.0, 1.0, 2.0)], -1)
        img = 127.5 + 90 * base + 20 * rng.normal(size=(h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def profile_paths(cache, inp, paths):
    """torch.profiler over one warm funnel run of each path (label,
    images): device time by kernel, and K1's and K2's share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    for label, imgs in paths:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in core_generation_funnel(None, imgs, None, None, inp,
                                            predictor_cache=cache):
                pass
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            dev[e.key] = dev.get(e.key, 0.0) + t / 1e3
        total = sum(dev.values())
        if total <= 0:
            raise AssertionError("the profiler saw no device time")
        k1 = sum(t for k, t in dev.items() if "flash_fwd" in k)
        k2_sort = sum(t for k, t in dev.items() if "polylines_sort" in k)
        k2_sweep = sum(t for k, t in dev.items() if "polylines_sweep" in k)
        k2 = k2_sort + k2_sweep
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
        log("profile", path=label, wall_ms=f"{wall_ms:.2f}",
            device_ms=f"{total:.2f}", busy=f"{total / wall_ms:.3f}",
            k1_ms=f"{k1:.2f}", k1_share=f"{k1 / total:.3f}",
            k2_ms=f"{k2:.2f}", k2_share=f"{k2 / total:.3f}",
            k2_sort_ms=f"{k2_sort:.2f}", k2_sweep_ms=f"{k2_sweep:.2f}",
            top=repr([(k[:48], round(t, 3)) for k, t in top]))


def backbone_shape(module):
    """(blocks, width, heads) of a transformer backbone (BEiT, ViT, the
    hybrid, DINOv2); (0, None, None) for a conv encoder."""
    bb = module.pretrained
    blocks = bb.model.blocks if hasattr(bb, "model") else \
        getattr(bb, "blocks", ())
    if len(blocks) == 0:
        return 0, None, None
    return (len(blocks), blocks[0].norm1.normalized_shape[0],
            blocks[0].attn.num_heads)


def attention_tokens(pred, inp, img):
    """N of the backbone's attention for one funnel image: the token grid
    of the net input that the funnel's net size and the model's resize
    rule give, plus the cls token; None for a conv model."""
    from depthmap_tpu_torch.pipeline.core import _funnel_net_size
    from depthmap_tpu_torch.pipeline.preprocess import net_input_size
    h, w = img.shape[:2]
    nw, nh = _funnel_net_size(inp, w, h)
    iw, ih = net_input_size(w, h, nw, nh, pred.bundle.preprocess)
    bb = pred.bundle.module.pretrained
    if hasattr(bb, "grid_for"):
        gh, gw = bb.grid_for((ih, iw))
    elif hasattr(bb, "patch_size"):
        gh, gw = ih // bb.patch_size, iw // bb.patch_size
    else:
        return None
    return gh * gw + 1


def drive_funnel(phase, inp, images, groups, forwards, k2_eyes,
                 profile=False, runs=MAIN_RUNS, mesh_image=None):
    """One path through PredictorCache and core_generation_funnel at full
    width (random weights, seed 0): a warm-up run, then ``runs`` timed
    runs, each with every kernel count set to 0 just before it and read
    just after.  ``groups``: (label, number of images) in input order, each
    timed to its last image's last output.  Each run must launch K1 once
    per block and forward (0 times for a conv model), and K2's sort and
    sweep ``k2_eyes`` times each; every output's dtype and shape is
    checked.  With ``mesh_image``, one more run on it with the simple mesh
    only, into a temporary directory: its OBJ must hold a vertex a pixel.
    Returns the last timed run's (K1, K2 sweep) launches."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    from depthmap_tpu_torch.pipeline.core import (PredictorCache,
                                                  core_generation_funnel)
    cache = PredictorCache()
    t0 = time.perf_counter()
    pred = cache.get(inp.model_type, device=torch.device("cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    blocks, width, heads = backbone_shape(pred.bundle.module)
    # warm-up run: cuDNN algorithm choice and the per-grid hoists
    for _ in core_generation_funnel(None, images, None, None, inp,
                                    predictor_cache=cache):
        pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tokens = sorted({attention_tokens(pred, inp, img) for img in images}
                    - {None})

    for run in range(runs):
        fa.flash_attention_cuda.launches = 0
        pl._sort_cuda.launches = 0
        pl._sweep_cuda.launches = 0
        results, last = {}, {}
        t_start = time.perf_counter()
        for idx, typ, res in core_generation_funnel(
                None, images, None, None, inp, predictor_cache=cache):
            results[(idx, typ)] = res
            last[idx] = time.perf_counter()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        k1 = fa.flash_attention_cuda.launches
        k2_sort = pl._sort_cuda.launches
        k2 = pl._sweep_cuda.launches

        for i, img in enumerate(images):
            h, w = img.shape[:2]
            d = results[(i, "depth")]
            assert d.dtype == np.uint16 and d.shape == (h, w), (i, d.shape)
            assert int(d.max()) - int(d.min()) > 0, \
                f"image {i}: constant depth"
            if inp.gen_stereo:
                sbs = results[(i, "left-right")]
                ana = results[(i, "red-cyan-anaglyph")]
                assert sbs.dtype == np.uint8 and sbs.shape == (h, 2 * w, 3)
                assert ana.dtype == np.uint8 and ana.shape == (h, w, 3)
            for typ, ch in (("normalmap", 3), ("heatmap", 4)):
                if getattr(inp, f"gen_{typ}"):
                    out = results[(i, typ)]
                    assert out.dtype == np.uint8 and out.shape == (h, w, ch), \
                        (typ, out.dtype, out.shape)
        if k1 != blocks * forwards:
            raise AssertionError(f"{phase}: K1 launched {k1} times, "
                                 f"expected {blocks} x {forwards}")
        if (k2_sort, k2) != (k2_eyes, k2_eyes):
            raise AssertionError(f"{phase}: K2 launched its sort {k2_sort} "
                                 f"and its sweep {k2} times, expected "
                                 f"{k2_eyes} each (one per eye)")
        times, first, prev = {}, 0, t_start
        for label, count in groups:
            end = last[first + count - 1]
            times[f"s_per_image_{label}"] = f"{(end - prev) / count:.4f}"
            first, prev = first + count, end
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(phase, run=run, model=pred.spec.name, blocks=blocks,
            width=width, heads=heads, tokens=tokens,
            dtype=str(pred.compute_dtype), build_s=f"{build_s:.2f}",
            fill=inp.stereo_fill_algo if inp.gen_stereo else None, **times,
            s_total=f"{t_end - t_start:.4f}", k1_launches=k1,
            k2_launches=k2, k2_sort_launches=k2_sort,
            max_memory_allocated_GiB=f"{peak_gib:.3f}")
    if mesh_image is not None:
        drive_mesh(phase, inp, mesh_image, cache, blocks)
    if profile:
        paths, first = [], 0
        for label, count in groups:
            paths.append((f"{phase}_{label}", images[first:first + count]))
            first += count
        profile_paths(cache, inp, paths)
    cache.release()
    del pred
    torch.cuda.empty_cache()
    return k1, k2


def drive_mesh(phase, inp, image, cache, blocks):
    """The simple mesh of one image through the funnel (the raw map goes to
    the host: serial path, one forward), written to a temporary directory
    and read back: a vertex a pixel, K1 launched once per block."""
    import dataclasses
    import tempfile
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    h, w = image.shape[:2]
    mesh_inp = dataclasses.replace(inp, do_output_depth=False,
                                   gen_normalmap=False, gen_heatmap=False,
                                   gen_stereo=False, gen_simple_mesh=True)
    with tempfile.TemporaryDirectory() as tmp:
        fa.flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        out = list(core_generation_funnel(tmp, [image], None, None, mesh_inp,
                                          predictor_cache=cache))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1 = fa.flash_attention_cuda.launches
        assert [typ for _, typ, _ in out] == ["simple_mesh"], out
        path = out[0][2]
        with open(path) as f:
            lines = f.readlines()
        verts = sum(1 for line in lines if line.startswith("v "))
        faces = sum(1 for line in lines if line.startswith("f "))
        log(phase, mesh=os.path.basename(path), vertices=verts, faces=faces,
            obj_MB=f"{os.path.getsize(path) / 1e6:.1f}",
            s_mesh=f"{seconds:.3f}", k1_launches=k1)
    if verts != h * w or faces == 0:
        raise AssertionError(f"{phase}: the mesh has {verts} vertices and "
                             f"{faces} faces, expected {h * w} vertices")
    if k1 != blocks:
        raise AssertionError(f"{phase}: the mesh run launched K1 {k1} "
                             f"times, expected {blocks}")


def phase_main_path(profile: bool = False):
    """dpt_beit_large_512 with polylines_sharp stereo: 4 x 512^2 on the
    batched pre-pass, one 1080p image on the serial path (inline
    per-block bias, table resize)."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(compute_device="GPU",
                            model_type="dpt_beit_large_512",
                            net_width=512, net_height=512, gen_stereo=True,
                            stereo_modes=["left-right", "red-cyan-anaglyph"],
                            stereo_fill_algo="polylines_sharp")
    return drive_funnel("4-main", inp, images,
                        [("512_batched", 4), ("1080p_serial", 1)],
                        forwards=2, k2_eyes=2 * len(images), profile=profile)


def phase_default_options(profile: bool = False):
    """GenerationOptions() defaults (Depth Anything v2 Base, net 448^2)
    with naive-fill stereo: 4 x 512^2 batched (N = 1025), one 1080p image
    serial (N = 1825)."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(6, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(gen_stereo=True, stereo_fill_algo="naive")
    return drive_funnel("6-default", inp, images,
                        [("512_batched", 4), ("1080p_serial", 1)],
                        forwards=2, k2_eyes=0, profile=profile)


def phase_long_n(profile: bool = False):
    """Depth Anything v2 Large with net_size_match on one 1080p image,
    depth only: net 1932 x 1092, a 78 x 138 grid, N = 10765."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(7, [(1080, 1920)])
    inp = GenerationOptions(model_type="Depth Anything v2 Large",
                            net_size_match=True)
    return drive_funnel("7-long-n", inp, images, [("1080p_serial", 1)],
                        forwards=1, k2_eyes=0, profile=profile, runs=2)


def phase_dpt_large(profile: bool = False):
    """This slice's path: dpt_large_384 with depth, normal map and
    heatmap on the images of phase 4 at net 384: 4 x 512^2 batched (N =
    577), one 1080p image serial (672 x 384, N = 1009); then the simple
    mesh of one 512^2 image."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(compute_device="GPU", model_type="dpt_large_384",
                            net_width=384, net_height=384,
                            gen_normalmap=True, gen_heatmap=True)
    k1, _ = drive_funnel("9-dpt-large", inp, images,
                         [("512_batched", 4), ("1080p_serial", 1)],
                         forwards=2, k2_eyes=0, profile=profile,
                         mesh_image=images[0])
    return k1


def phase_zoo(profile: bool = False):
    """dpt_hybrid_384, midas_v21 and midas_v21_small at their default net
    sizes on the images of phase 4, depth, normal map and heatmap, 2 timed
    runs each: K1 12 times a forward for the hybrid, never for the conv
    nets."""
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.registry import get_default_net_size
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    launches = {}
    for name in ("dpt_hybrid_384", "midas_v21", "midas_v21_small"):
        nw, nh = get_default_net_size(name)
        inp = GenerationOptions(compute_device="GPU", model_type=name,
                                net_width=nw, net_height=nh,
                                gen_normalmap=True, gen_heatmap=True)
        launches[name], _ = drive_funnel(
            f"10-{name}", inp, images,
            [("512_batched", 4), ("1080p_serial", 1)], forwards=2,
            k2_eyes=0, profile=profile, runs=2)
    return launches


def phase_normalmap():
    """The normal map at 1080 x 1920 on the random and the smooth map of
    phase 8, every option, card against the port's CPU: |d| <= 1 on <=
    0.1% of the bytes (the JAX package's bound against the reference);
    ms per map on the card (CUDA events, the map already on the card)."""
    import itertools
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops.normalmap import create_normalmap
    rng = np.random.default_rng(8)
    rows, w = 1080, 1920
    yy, xx = np.mgrid[0:rows, 0:w]
    smooth = 0.5 + 0.5 * np.sin(xx / 97.0) * np.cos(yy / 61.0)
    maps = {k: (d * 65535).astype(np.uint16) for k, d in
            (("random", rng.random((rows, w))), ("smooth", smooth))}
    on_card = {k: torch.from_numpy(d.astype(np.float32)).cuda()
               for k, d in maps.items()}
    all_ms = []
    for pre, sob, post in itertools.product((None, 3, 5), (None, 1, 3, 5),
                                            (None, 3)):
        worst, share, ms = 0, 0.0, []
        for kind, inv in itertools.product(maps, (False, True)):
            args = (pre, sob, post, inv)
            got = create_normalmap(on_card[kind], *args).cpu().numpy()
            want = create_normalmap(maps[kind], *args).numpy()
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            worst = max(worst, int(d.max()))
            share = max(share, float((d > 0).mean()))
            ms.append(cuda_ms(lambda: create_normalmap(on_card[kind], *args),
                              5))
        all_ms += ms
        log("11-normalmap", pre_blur=pre, sobel=sob, post_blur=post,
            max_abs_diff=worst, share_differing=f"{share:.2e}",
            ms_per_map=f"{min(ms):.3f}-{max(ms):.3f}")
        if worst > 1 or share > 1e-3:
            raise AssertionError(
                f"normal map pre={pre} sobel={sob} post={post}: card vs CPU "
                f"|d| {worst}, {share:.2e} of the bytes differ")
    log("11-normalmap", maps=len(all_ms),
        ms_mean=f"{sum(all_ms) / len(all_ms):.3f}",
        ms_min=f"{min(all_ms):.3f}", ms_max=f"{max(all_ms):.3f}")
    # the funnel's other derived output, for scale: the heatmap is numpy
    # on the host (byte-equal to the JAX package's)
    from depthmap_tpu_torch.ops.heatmap import colorize
    host_ms = []
    for d in maps.values():
        for _ in range(3):
            t0 = time.perf_counter()
            colorize(d, cmap="inferno")
            host_ms.append((time.perf_counter() - t0) * 1e3)
    log("11-heatmap", shape=f"{rows}x{w}", host_ms_min=f"{min(host_ms):.1f}",
        host_ms_max=f"{max(host_ms):.1f}")


def phase_warp_fills(k2_ms: float):
    """The warp stereo fills at 1080 x 1920, one eye each, on a random and
    a smooth depth map, at +-24 px (1.25%), separation 0 and 0.25% (4.8
    px), exponent 1 and 1.7 (where the card's and the CPU's f32 pow may
    differ in the last bit; the random map holds nearly every 16-bit
    level): the card's eye byte-equal to the port's CPU eye; ms per eye on
    the card beside K2's ms per 1080p eye (phase 3)."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import stereo as S
    rng = np.random.default_rng(8)
    rows, w = 1080, 1920
    img = torch.from_numpy(rng.integers(0, 256, (rows, w, 3),
                                        dtype=np.uint8))
    yy, xx = np.mgrid[0:rows, 0:w]
    smooth = 0.5 + 0.5 * np.sin(xx / 97.0) * np.cos(yy / 61.0)
    depths = {"random": rng.random((rows, w)), "smooth": smooth}
    timed = {}
    for kind, d in depths.items():
        depth = torch.from_numpy((d * 65535).astype(np.uint16))
        img_c, depth_c = img.cuda(), depth.cuda()
        cases = [(fill, div, sep, ex) for fill in S.WARP_FILLS
                 for div in (1.25, -1.25) for sep in (0.0, 0.25)
                 for ex in (1.0, 1.7)]
        for fill, div, sep, ex in cases:
            got = S.apply_stereo_divergence(img_c, depth_c, div, sep, ex,
                                            fill)
            torch.cuda.synchronize()
            want = S.apply_stereo_divergence(img, depth, div, sep, ex, fill)
            ndiff = int((got.cpu() != want).sum())
            ms = cuda_ms(lambda: S.apply_stereo_divergence(
                img_c, depth_c, div, sep, ex, fill), 5)
            timed.setdefault(fill, []).append(ms)
            log("8-warp", depth=kind, fill=fill, divergence_px=div * w / 100,
                separation_px=sep * w / 100, exponent=ex, bytes_differ=ndiff,
                ms_per_eye=f"{ms:.4f}", k2_ms_per_eye=f"{k2_ms:.4f}")
            if ndiff:
                raise AssertionError(
                    f"warp fill {fill} {kind} div={div} sep={sep} "
                    f"exponent={ex}: {ndiff} bytes differ between card and "
                    "CPU")
    log("8-warp", **{f"{f}_ms_mean": f"{sum(t) / len(t):.4f}"
                     for f, t in timed.items()}, k2_ms=f"{k2_ms:.4f}")


def phase_numerics():
    """Whole-path f32 numerics, card (kernels, TF32 off) against CPU (plain
    versions): dpt_beit_large_512 at 512^2 (K1 with bias, 24 launches),
    Depth Anything v2 Base at 518^2 (K1 bias-free at N = 1370, 12),
    dpt_large_384 and dpt_hybrid_384 at 384^2 (N = 577: 24 and 12),
    midas_v21 at 384^2 and midas_v21_small at 256^2 (no attention: 0)."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    for mt, size, launches in ((1, 512, 24), (13, 518, 12), (3, 384, 24),
                               (4, 384, 12), (5, 384, 0), (6, 256, 0)):
        sd = init_random_(build_model(mt).module, seed=4).state_dict()
        img = _test_images(5, [(size, size)])[0].astype(np.float32) / 255.0
        gpu = DepthPredictor(mt, state_dict=sd, compute_dtype=torch.float32,
                             device="cuda")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        before = fa.flash_attention_cuda.launches
        on_card = gpu.predict(img, size, size)
        launched = fa.flash_attention_cuda.launches - before
        del gpu
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu = DepthPredictor(mt, state_dict=sd, compute_dtype=torch.float32,
                             device="cpu")
        on_cpu = cpu.predict(img, size, size)
        cpu_s = time.perf_counter() - t0
        rng_ = float(on_cpu.max() - on_cpu.min())
        err = float(np.abs(on_card - on_cpu).max())
        log("5-numerics", model=cpu.spec.name, size=size,
            k1_launches=launched, cpu_range=f"{rng_:.4e}",
            max_abs_diff=f"{err:.4e}", rel_to_range=f"{err / rng_:.3e}",
            bound=PATH_RTOL, cpu_seconds=f"{cpu_s:.1f}")
        if launched != launches:
            raise AssertionError(f"{cpu.spec.name}: f32 card forward "
                                 f"launched K1 {launched} times, expected "
                                 f"{launches}")
        if not (rng_ > 0 and err <= PATH_RTOL * rng_):
            raise AssertionError(f"{cpu.spec.name} card vs CPU: {err} > "
                                 f"{PATH_RTOL} x {rng_}")


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    smi = phase_environment()
    phase_build()
    k1_err, k1 = phase_k1()
    k2_err, k2 = phase_k2()
    k1_by_path = {}
    k1_by_path["dpt_beit_large_512"], k2_launches = phase_main_path(profile)
    phase_numerics()
    k1_by_path["default_options_da_v2_base"], _ = \
        phase_default_options(profile)
    k1_by_path["long_n_da_v2_large"], _ = phase_long_n(profile)
    phase_warp_fills(k2["ms"])
    k1_by_path["dpt_large_384"] = phase_dpt_large(profile)
    k1_by_path.update(phase_zoo(profile))
    phase_normalmap()
    import torch

    def row(name, source, replaces, launches, err, t, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **extra}
    print(smi)
    print(json.dumps({"kernels": [
        # K1's launches: the sum over the model paths (each counted from 0
        # in its own last timed run), per path beside it
        row("flash_attention", K1_SOURCE, K1_REPLACES,
            sum(k1_by_path.values()), k1_err, k1,
            device_ms=k1["device_ms"], launches_by_path=k1_by_path),
        # K2's launches: its sweep's, one per eye of the BEiT path's
        # polylines stereo (each eye also launched one sort, checked there)
        row("polylines", K2_SOURCE, K2_REPLACES, k2_launches, k2_err, k2),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
