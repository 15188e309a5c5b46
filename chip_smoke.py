#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py             # the smoke test
    python3 chip_smoke.py --profile   # and a device-time breakdown

Phases (each prints one line with its numbers; any failure exits non-zero
and prints no result):
  0. environment: CUDA required; torch / CUDA versions, the card's name
     and power limit from nvidia-smi, whether PIL and cv2 import;
  1. build: nvcc builds both hand-written kernels from csrc/ (in
     parallel); ptxas's register / spill report of each kernel; the count
     of HGMMA (wgmma) instructions in K1's SASS, which must not be 0;
  2. K1 (flash attention) against its plain version at the main path's
     shapes, bf16 (tensor-core body) and f32 (CUDA-core body), with a
     padded-row bias and without; per case the kernel's time, the plain
     version's, SDPA's on the same tensors (efficient-attention backend
     pinned; the port never calls it), the bound and the share of it;
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
  5. whole-path numerics: one 512x512 image through the predictor in f32
     on the card (kernels, TF32 off) and on the CPU (plain versions).
With --profile, torch.profiler over one warm funnel run per path gives
each path's device time and K1's / K2's share of it (K2: both stages).
The last lines: the card's name and power limit, a JSON line with each
kernel's numbers, and {"ok": true, "device": {...}}.
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
# outputs of these random inputs.
K1_BOUND = {"float32": 5e-3, "bfloat16": 2e-2}
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


def phase_k1():
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from depthmap_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(1)
    cases = [  # (name, dtype, B, N, bias batch or None); the first two are
        # the main path's bf16 calls, f32_b1_n1025_shared the f32 path's of
        # phase 5; every bias is in the padded-row layout
        ("bf16_b4_n1025_shared", torch.bfloat16, 4, 1025, 1),
        ("bf16_b1_n1793_shared", torch.bfloat16, 1, 1793, 1),
        ("bf16_b2_n1025_shared", torch.bfloat16, 2, 1025, 1),
        ("bf16_b2_n1025_none", torch.bfloat16, 2, 1025, None),
        ("f32_b1_n1025_shared", torch.float32, 1, 1025, 1),
        ("f32_b2_n130_batched", torch.float32, 2, 130, 2),
        ("f32_b2_n130_none", torch.float32, 2, 130, None),
        ("f32_b2_n513_batched", torch.float32, 2, 513, 2),
        ("f32_b2_n513_none", torch.float32, 2, 513, None),
    ]
    worst = 0.0
    main = None
    for name, dt, b, n, bb in cases:
        def mk(*shape):
            return torch.randn(*shape, generator=g).to("cuda", dt)
        q, k, v = mk(b, 16, n, 64), mk(b, 16, n, 64), mk(b, 16, n, 64)
        bias = fa.pad_bias_rows(mk(bb, 16, n, n)) if bb else None
        got = fa.flash_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, bias)
        err = (got.float() - want.float()).abs().max().item()
        dts = str(dt).split(".")[-1]
        tol = K1_BOUND[dts]
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, bias), 20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                           5)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), 20)
        bound_ms, basis = k1_bound(b, 16, n, n, bb, dts)
        log("2-k1", case=name, max_abs_err=f"{err:.3e}", tol=tol,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", bound_us=f"{bound_ms * 1e3:.1f}",
            bound_by=basis, share_of_bound=f"{bound_ms / ms:.3f}")
        if not err <= tol:
            raise AssertionError(f"K1 {name}: max abs err {err} > {tol}")
        worst = max(worst, err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=basis)
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


def profile_paths(cache, inp, images):
    """torch.profiler over one warm funnel run of each path: device time
    by kernel, and K1's and K2's share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    for label, imgs in (("512_batched_x4", images[:4]),
                        ("1080p_serial", images[4:])):
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
        log("4-profile", path=label, wall_ms=f"{wall_ms:.2f}",
            device_ms=f"{total:.2f}", busy=f"{total / wall_ms:.3f}",
            k1_ms=f"{k1:.2f}", k1_share=f"{k1 / total:.3f}",
            k2_ms=f"{k2:.2f}", k2_share=f"{k2 / total:.3f}",
            k2_sort_ms=f"{k2_sort:.2f}", k2_sweep_ms=f"{k2_sweep:.2f}",
            top=repr([(k[:48], round(t, 3)) for k, t in top]))


def phase_main_path(profile: bool = False):
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline.core import (PredictorCache,
                                                  core_generation_funnel)
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(compute_device="GPU",
                            model_type="dpt_beit_large_512",
                            net_width=512, net_height=512, gen_stereo=True,
                            stereo_modes=["left-right", "red-cyan-anaglyph"],
                            stereo_fill_algo="polylines_sharp")
    cache = PredictorCache()
    t0 = time.perf_counter()
    pred = cache.get(1, device=torch.device("cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    blocks = len(pred.bundle.module.pretrained.model.blocks)
    width = pred.bundle.module.pretrained.model.cls_token.shape[-1]
    # warm-up run: cuDNN algorithm choice and the per-grid bias hoist
    for _ in core_generation_funnel(None, images, None, None, inp,
                                    predictor_cache=cache):
        pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for run in range(MAIN_RUNS):
        fa.flash_attention_cuda.launches = 0
        pl._sort_cuda.launches = 0
        pl._sweep_cuda.launches = 0
        results = {}
        t_start = time.perf_counter()
        t_batched = None
        for idx, typ, res in core_generation_funnel(
                None, images, None, None, inp, predictor_cache=cache):
            results[(idx, typ)] = res
            if idx == 3 and typ == "red-cyan-anaglyph":
                t_batched = time.perf_counter()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        k1 = fa.flash_attention_cuda.launches
        k2_sort = pl._sort_cuda.launches
        k2 = pl._sweep_cuda.launches

        for i, img in enumerate(images):
            h, w = img.shape[:2]
            d = results[(i, "depth")]
            sbs = results[(i, "left-right")]
            ana = results[(i, "red-cyan-anaglyph")]
            assert d.dtype == np.uint16 and d.shape == (h, w), (i, d.shape)
            assert sbs.dtype == np.uint8 and sbs.shape == (h, 2 * w, 3)
            assert ana.dtype == np.uint8 and ana.shape == (h, w, 3)
            assert int(d.max()) - int(d.min()) > 0, \
                f"image {i}: constant depth"
        forwards = 2   # one batched forward of the 4 512^2 images, one 1080p
        if k1 != blocks * forwards:
            raise AssertionError(f"K1 launched {k1} times, expected "
                                 f"{blocks} x {forwards}")
        if (k2_sort, k2) != (2 * len(images),) * 2:
            raise AssertionError(f"K2 launched its sort {k2_sort} and its "
                                 f"sweep {k2} times, expected "
                                 f"{2 * len(images)} each (one per eye)")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log("4-main", run=run, model="dpt_beit_large_512", blocks=blocks,
            width=width, dtype=str(pred.compute_dtype),
            build_s=f"{build_s:.2f}",
            s_per_image_512_batched=f"{(t_batched - t_start) / 4:.4f}",
            s_per_image_1080p_serial=f"{t_end - t_batched:.4f}",
            k1_launches=k1, k2_launches=k2, k2_sort_launches=k2_sort,
            max_memory_allocated_GiB=f"{peak_gib:.3f}")
    if profile:
        profile_paths(cache, inp, images)
    cache.release()
    del pred
    torch.cuda.empty_cache()
    return k1, k2


def phase_numerics():
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    sd = init_random_(build_model(1).module, seed=4).state_dict()
    img = _test_images(5, [(512, 512)])[0].astype(np.float32) / 255.0
    before = fa.flash_attention_cuda.launches
    gpu = DepthPredictor(1, state_dict=sd, compute_dtype=torch.float32,
                         device="cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    on_card = gpu.predict(img)
    launched = fa.flash_attention_cuda.launches - before
    del gpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = DepthPredictor(1, state_dict=sd, compute_dtype=torch.float32,
                         device="cpu")
    on_cpu = cpu.predict(img)
    cpu_s = time.perf_counter() - t0
    rng_ = float(on_cpu.max() - on_cpu.min())
    err = float(np.abs(on_card - on_cpu).max())
    log("5-numerics", k1_launches=launched, cpu_range=f"{rng_:.4e}",
        max_abs_diff=f"{err:.4e}", rel_to_range=f"{err / rng_:.3e}",
        bound=PATH_RTOL, cpu_seconds=f"{cpu_s:.1f}")
    if launched != 24:
        raise AssertionError(f"f32 card forward launched K1 {launched} times")
    if not (rng_ > 0 and err <= PATH_RTOL * rng_):
        raise AssertionError(f"card vs CPU: {err} > {PATH_RTOL} x {rng_}")


def main() -> int:
    smi = phase_environment()
    phase_build()
    k1_err, k1 = phase_k1()
    k2_err, k2 = phase_k2()
    k1_launches, k2_launches = phase_main_path("--profile" in sys.argv[1:])
    phase_numerics()
    import torch

    def row(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}
    print(smi)
    print(json.dumps({"kernels": [
        row("flash_attention", K1_SOURCE, K1_REPLACES, k1_launches, k1_err,
            k1),
        # K2's launches: its sweep's, one per eye (each eye also launched
        # one sort, checked in phase 4)
        row("polylines", K2_SOURCE, K2_REPLACES, k2_launches, k2_err, k2),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
