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
     holds one key, and 1009; ZoeDepth's BEiT-L 384 core under flip TTA,
     its bias shared across the doubled batch: N = 1025 and 2305 at
     batch 8, 1009 and 1345 at batch 2, and 769 in f32; Boost on BEiT-L
     512, bf16 with the bias shared across the batch: the whole image at
     R_x 1536 on a 4:3 input (N = 6913) and on a square one (9217), the
     patches at 1024^2 (4 x 4097) and 512^2 (4 x 1025), the whole image at
     512 on a 4:3 input (769); Marigold's UNet at res 768 on a 4:3 input,
     bias-free, in f32 (what its attention runs in, in either dtype: in
     bf16 the UNet, as flax's promotion makes the JAX one, runs in f32
     past its first time-embedding add) and in bf16 (the tensor-core body
     at the same shapes): self-attention at (5, 5, 6912), (5, 10, 1728),
     (5, 20, 432) and (5, 20, 108), and cross-attention on the 77 keys of
     the empty prompt at each of those), on inputs that peak the softmax
     (K1_Q_SCALE); per case the kernel's time (CUDA events over 10 calls;
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
     dpt_large_384 and dpt_hybrid_384 at 384x384, midas_v21 at 384x384,
     midas_v21_small at 256x256, zoedepth_k and zoedepth_nk on a 384x512
     image (N = 769, 24 K1 launches) and res101 at 448x448 (none); then
     zoedepth_k at its default precision (bf16 core, f32 metric head) on
     the same image, on the card and on the CPU, each held to the card's
     f32 map: the card's drift within SELECTIVE_DRIFT_RATIO x the CPU's;
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
     the heatmap's host time on the same maps;
 12. this slice's paths, depth only, on the images of phase 4 at each
     model's default net size: zoedepth_n (MAIN_RUNS timed runs),
     zoedepth_k, zoedepth_nk and res101 (LeReS; 2 each): K1 24 times a
     forward for each ZoeDepth model (N = 1025 / 1009 for n and nk, 2305
     with the inline per-block bias / 1345 for k), never for LeReS; each
     at its default precision, checked: ZoeDepth's core in bf16 beside its
     f32 metric head, LeReS in f32;
 13. Boost through the funnel (DEPTHMAP_ALLOW_RANDOM_PIX2PIX=1, r_max
     1600), a warm run a model and a timed run an image: res101 (LeReS,
     f32, no kernel) on a 1080p and a 4:3 image, dpt_beit_large_512 on a
     textured 4:3 image whose whole-image pass runs at R_x 1536 (N =
     6913): R_x, the
     patches, s per image, peak memory, and K1 24 times a forward (two
     whole-image forwards and two a chunk of 4 patches); then the device
     chain (crop-resize, fit, blend) at 1080p with P = 1024 and the
     full-width pix2pix (1024^2, batch 1, f32), card against CPU;
 14. Marigold (type 10) through the funnel: a 4:3 image at res 768
     (latent 96 x 72), ensemble 5, 12 steps, in f32 (its default) and in
     bf16 (DEPTHMAP_MARIGOLD_DTYPE: bf16 weights, the VAE in bf16, the
     UNet in f32 past its first time-embedding add, the attention's
     dtype logged), one warm and one timed run each: K1 32
     times a UNet forward, 384 an image; s per image, peak memory; then the
     full-width nets at processing_res 64, ensemble 2, 2 steps, the same
     noise, f32, card against CPU (the members before the ensemble).
Each model path (4, 6, 7, 9, 10, 12, 13, 14) sets every kernel count to 0
just
before each timed run and reads it just after.  With --profile, torch.profiler
over one warm funnel run per path gives each path's device time and K1's
/ K2's share of it (K2: both stages).  The last lines: the card's name and power
limit, a JSON line with each kernel's numbers (K1's launches: the sum over
phases 4, 6, 7, 9, 10 and 12, each path's count beside it; K2's: phase 4's
sweeps),
and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
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
# zoedepth_k at its default precision (bf16 core, f32 metric head): the
# card's drift from the f32 map (mean relative difference) against the
# CPU's, whose bf16 plain attention rounds p before p.v as K1 does.  Two
# bf16 paths that round in different places should drift about equally;
# with random weights the two selective maps differ by ~2% on average
# (24 blocks, then the log-binomial softmax at t down to 0.0212), too
# close to a fixed bound to hold them to each other.  A kernel fault (an
# output off by >= 0.2, phase 2) would multiply the card's drift.
SELECTIVE_DRIFT_RATIO = 2.0
# timed runs of the main path (each resets and checks the launch counts),
# for the spread of its host-clock times
MAIN_RUNS = 2
# Boost's device chain, card against the port's CPU (max abs error, maps in
# [0, 1]): the same f32 weight matrices (built with the same operations),
# products summed over up to 3000 terms in another order
BOOST_CHAIN_TOL = 2e-5
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


K1_CASES = [  # (name, dtype, B, H, N, bias batch or None[, Nk]; Nk = N
    # where it is not given); the first two
    # are the BEiT path's bf16 calls, f32_b1_n1025_shared its f32 call of
    # phase 5; every bias is in the padded-row layout.  The bias-free
    # h6/h12/h16 cases are Depth Anything's calls: v2 Base at 512^2
    # (net 448, N = 1025) and 1080p (N = 1825), its f32 call at 518^2
    # (N = 1370), v2 Large at 518^2 and at 1080p with net_size_match
    # (N = 10765, bound by operations)
    ("bf16_b4_h16_n1025_shared", "bfloat16", 4, 16, 1025, 1),
    ("bf16_b1_h16_n1793_shared", "bfloat16", 1, 16, 1793, 1),
    ("bf16_b2_h16_n1025_shared", "bfloat16", 2, 16, 1025, 1),
    ("bf16_b2_h16_n1025_none", "bfloat16", 2, 16, 1025, None),
    ("f32_b1_h16_n1025_shared", "float32", 1, 16, 1025, 1),
    ("f32_b2_h16_n130_batched", "float32", 2, 16, 130, 2),
    ("f32_b2_h16_n130_none", "float32", 2, 16, 130, None),
    ("f32_b2_h16_n513_batched", "float32", 2, 16, 513, 2),
    ("f32_b2_h16_n513_none", "float32", 2, 16, 513, None),
    ("bf16_b4_h12_n1025_none", "bfloat16", 4, 12, 1025, None),
    ("bf16_b1_h12_n1825_none", "bfloat16", 1, 12, 1825, None),
    ("bf16_b1_h16_n1370_none", "bfloat16", 1, 16, 1370, None),
    ("bf16_b1_h16_n10765_none", "bfloat16", 1, 16, 10765, None),
    ("f32_b1_h12_n1370_none", "float32", 1, 12, 1370, None),
    # MiDaS 3.0: ViT-L (16 heads) and the hybrid's ViT-B (12) at 512^2
    # on net 384 (a 24 x 24 grid: N = 577, one key in the last kv
    # tile) and at 1080p (672 x 384: 42 x 24, N = 1009); BEiT-384's
    # biased call at N = 577 (rows padded to 592)
    ("bf16_b4_h16_n577_none", "bfloat16", 4, 16, 577, None),
    ("bf16_b1_h16_n1009_none", "bfloat16", 1, 16, 1009, None),
    ("bf16_b4_h12_n577_none", "bfloat16", 4, 12, 577, None),
    ("bf16_b1_h12_n1009_none", "bfloat16", 1, 12, 1009, None),
    ("bf16_b1_h16_n577_shared", "bfloat16", 1, 16, 577, 1),
    # ZoeDepth's BEiT-L 384 under flip TTA (batch = 2 x images, one
    # bias for all): n / nk at 4 x 512^2 (net 512^2, N = 1025) and
    # 1080p (384 x 672, N = 1009); k at 4 x 512^2 (768^2, N = 2305,
    # the inline per-block bias) and 1080p (448 x 768, N = 1345); the
    # f32 call of phase 5 at 384 x 512 (N = 769)
    ("bf16_b8_h16_n1025_shared", "bfloat16", 8, 16, 1025, 1),
    ("bf16_b2_h16_n1009_shared", "bfloat16", 2, 16, 1009, 1),
    ("bf16_b8_h16_n2305_shared", "bfloat16", 8, 16, 2305, 1),
    ("bf16_b2_h16_n1345_shared", "bfloat16", 2, 16, 1345, 1),
    ("f32_b2_h16_n769_shared", "float32", 2, 16, 769, 1),
    # Boost on BEiT-L 512 (bf16, one bias for the batch; above
    # BIAS_HOIST_CAP each block gathers its own): the whole image at R_x
    # 1536 (1536 x 1152 on a 4:3 input: 96 x 72 + 1; 1536^2: 96^2 + 1),
    # the patches at 1024^2 (64^2 + 1; at 512^2 they are the main
    # path's (4, 16, 1025) above), the whole image at 512 on a 4:3
    # input (32 x 24 + 1)
    ("bf16_b1_h16_n6913_shared", "bfloat16", 1, 16, 6913, 1),
    ("bf16_b1_h16_n9217_shared", "bfloat16", 1, 16, 9217, 1),
    ("bf16_b4_h16_n4097_shared", "bfloat16", 4, 16, 4097, 1),
    ("bf16_b1_h16_n769_shared", "bfloat16", 1, 16, 769, 1),
    # Marigold's UNet at res 768 on a 4:3 input (latent 96 x 72,
    # ensemble 5 on the batch): self-attention at the four levels,
    # bias-free, then cross-attention on the empty prompt's 77 keys (13
    # in the last kv tile); f32 is what the UNet's attention runs in (in
    # its bf16 mode too), bf16 holds the tensor-core body at its shapes
    *[(f"{dn}_b5_h{h}_n{n}_{kind}", dt, 5, h, n, None,
       *((77,) if kind == "cross77" else ()))
      for dn, dt in (("f32", "float32"), ("bf16", "bfloat16"))
      for kind in ("self", "cross77")
      for h, n in ((5, 6912), (10, 1728), (20, 432), (20, 108))],
]


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
    worst = 0.0
    main = None
    for name, dts, b, h, n, bb, *rest in K1_CASES:
        nk = rest[0] if rest else n
        dt = getattr(torch, dts)

        def mk(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to("cuda", dt)
        q = mk(b, h, n, 64, scale=K1_Q_SCALE)
        k, v = mk(b, h, nk, 64), mk(b, h, nk, 64, scale=K1_V_SCALE)
        bias = fa.pad_bias_rows(mk(bb, h, n, nk)) if bb else None
        got = fa.flash_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, bias)
        err = (got.float() - want.float()).abs().max().item()
        tol = K1_BOUND[dts]
        faults = k1_fault_errors(q, k, v, bias, want)
        del want
        torch.cuda.empty_cache()
        def k1_call():
            return fa.flash_attention_cuda(q, k, v, bias)
        ms = cuda_ms(k1_call, 10)
        dev_ms = device_ms(k1_call, 5)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                           3)
        # SDPA on the same tensors: the efficient backend takes the
        # padded-row mask; the flash backend takes no mask and no f32
        library, library_dev = {}, {}
        backends = [("efficient", SDPBackend.EFFICIENT_ATTENTION)]
        if bias is None and dt == torch.bfloat16:
            backends.append(("flash", SDPBackend.FLASH_ATTENTION))
        for lib, backend in backends:
            def sdpa_call():
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=bias)
            library[lib] = cuda_ms(sdpa_call, 10)
            library_dev[lib] = device_ms(sdpa_call, 5)
        bound_ms, basis = k1_bound(b, h, n, nk, bb, dts)
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


def profile_paths(cache, inp, paths, ops=None):
    """torch.profiler over one warm funnel run of each path (label,
    images; the funnel's ``ops``): device time by kernel, and K1's and
    K2's share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    for label, imgs in paths:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in core_generation_funnel(None, imgs, None, None, inp, ops,
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


def dpt_of(module):
    """The DPT inside a model (ZoeDepth's relative-depth core), or the
    model itself."""
    zoe = getattr(module, "model", None)
    return zoe.core.core if zoe is not None else module


def backbone_shape(module):
    """(blocks, width, heads) of a transformer backbone (BEiT, ViT, the
    hybrid, DINOv2); (0, None, None) for a conv encoder."""
    bb = getattr(dpt_of(module), "pretrained", None)
    blocks = () if bb is None else bb.model.blocks if hasattr(bb, "model") \
        else getattr(bb, "blocks", ())
    if len(blocks) == 0:
        return 0, None, None
    return (len(blocks), blocks[0].norm1.normalized_shape[0],
            blocks[0].attn.num_heads)


def attention_tokens(pred, inp, img):
    """N of the backbone's attention for one funnel image: the token grid
    of the net input that the funnel's net size and the model's resize
    rule give (ZoeDepth's own, inside the model), plus the cls token; None
    for a conv model."""
    from depthmap_tpu_torch.pipeline.core import _funnel_net_size
    from depthmap_tpu_torch.pipeline.preprocess import net_input_size
    h, w = img.shape[:2]
    nw, nh = _funnel_net_size(inp, w, h)
    module = pred.bundle.module
    if pred.bundle.prep_in_model:
        ih, iw = module.net_input_size(h, w, (nh, nw), module.img_size)
    else:
        iw, ih = net_input_size(w, h, nw, nh, pred.bundle.preprocess)
    bb = getattr(dpt_of(module), "pretrained", None)
    if hasattr(bb, "grid_for"):
        gh, gw = bb.grid_for((ih, iw))
    elif hasattr(bb, "patch_size"):
        gh, gw = ih // bb.patch_size, iw // bb.patch_size
    else:
        return None
    return gh * gw + 1


def drive_funnel(phase, inp, images, groups, forwards, k2_eyes,
                 profile=False, runs=MAIN_RUNS, mesh_image=None, dtypes=None):
    """One path through PredictorCache and core_generation_funnel at full
    width (random weights, seed 0): a warm-up run, then ``runs`` timed
    runs, each with every kernel count set to 0 just before it and read
    just after.  ``groups``: (label, number of images) in input order, each
    timed to its last image's last output.  Each run must launch K1 once
    per block and forward (0 times for a conv model), and K2's sort and
    sweep ``k2_eyes`` times each; every output's dtype and shape is
    checked.  With ``mesh_image``, one more run on it with the simple mesh
    only, into a temporary directory: its OBJ must hold a vertex a pixel.
    With ``dtypes`` (compute, core), the predictor must run in them and the
    core's weights must be in the core dtype.  Returns the last timed
    run's (K1, K2 sweep) launches."""
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
    core_weights = next(dpt_of(pred.bundle.module).parameters()).dtype
    if dtypes is not None and (pred.compute_dtype, pred.core_dtype,
                               core_weights) != (*dtypes, dtypes[1]):
        raise AssertionError(
            f"{phase}: compute {pred.compute_dtype}, core {pred.core_dtype}"
            f" (weights {core_weights}), expected {dtypes}")
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
            dtype=str(pred.compute_dtype), core_dtype=str(pred.core_dtype),
            core_weights=str(core_weights), build_s=f"{build_s:.2f}",
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


def phase_metric_zoo(profile: bool = False):
    """This slice's paths on the images of phase 4 at each model's default
    net size, depth only: zoedepth_n (MAIN_RUNS timed runs), zoedepth_k,
    zoedepth_nk and res101 (2 each).  ZoeDepth runs K1 24 times a forward
    (flip TTA: batch 8 for the 4 batched images, 2 for the 1080p one);
    LeReS never.  Each runs at its default precision: ZoeDepth's core in
    bf16 beside its f32 metric head, LeReS in f32."""
    import torch
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.registry import get_default_net_size
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    launches = {}
    for name, runs in (("zoedepth_n", MAIN_RUNS), ("zoedepth_k", 2),
                       ("zoedepth_nk", 2), ("res101", 2)):
        nw, nh = get_default_net_size(name)
        inp = GenerationOptions(compute_device="GPU", model_type=name,
                                net_width=nw, net_height=nh)
        core = torch.float32 if name == "res101" else torch.bfloat16
        launches[name], _ = drive_funnel(
            f"12-{name}", inp, images,
            [("512_batched", 4), ("1080p_serial", 1)], forwards=2,
            k2_eyes=0, profile=profile, runs=runs,
            dtypes=(torch.float32, core))
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


def empty_bundle(mt):
    """build_model(mt)'s bundle with its module built on the meta device
    and then allocated on the host, uninitialised (every parameter and
    buffer is in its state dict): a predictor given a state dict fills it,
    without the default init of a full-width model first."""
    import torch
    from depthmap_tpu_torch.models.build import build_model
    with torch.device("meta"):
        bundle = build_model(mt)
    bundle.module.to_empty(device="cpu")
    return bundle


def phase_numerics():
    """Whole-path f32 numerics, card (kernels, TF32 off) against CPU (plain
    versions): dpt_beit_large_512 at 512^2 (K1 with bias, 24 launches),
    Depth Anything v2 Base at 518^2 (K1 bias-free at N = 1370, 12),
    dpt_large_384 and dpt_hybrid_384 at 384^2 (N = 577: 24 and 12),
    midas_v21 at 384^2 and midas_v21_small at 256^2 (no attention: 0),
    zoedepth_k and zoedepth_nk on a 384 x 512 image at their default net
    sizes (net input 384 x 512 under flip TTA: K1 with the bias at N =
    769, batch 2, 24 launches) and res101 at 448^2 (0)."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    from depthmap_tpu_torch.registry import get_default_net_size
    for mt, (h, w), launches in ((1, (512, 512), 24), (13, (518, 518), 12),
                                 (3, (384, 384), 24), (4, (384, 384), 12),
                                 (5, (384, 384), 0), (6, (256, 256), 0),
                                 (8, (384, 512), 24), (9, (384, 512), 24),
                                 (0, (448, 448), 0)):
        net_w, net_h = (w, h) if mt not in (8, 9) else \
            get_default_net_size(mt)
        sd = init_random_(build_model(mt).module, seed=4).state_dict()
        img = _test_images(5, [(h, w)])[0].astype(np.float32) / 255.0
        gpu = DepthPredictor(mt, state_dict=sd, compute_dtype=torch.float32,
                             device="cuda", bundle=empty_bundle(mt))
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        before = fa.flash_attention_cuda.launches
        on_card = gpu.predict(img, net_w, net_h)
        launched = fa.flash_attention_cuda.launches - before
        del gpu
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu = DepthPredictor(mt, state_dict=sd, compute_dtype=torch.float32,
                             device="cpu", bundle=empty_bundle(mt))
        on_cpu = cpu.predict(img, net_w, net_h)
        cpu_s = time.perf_counter() - t0
        rng_ = float(on_cpu.max() - on_cpu.min())
        err = float(np.abs(on_card - on_cpu).max())
        log("5-numerics", model=cpu.spec.name, size=f"{h}x{w}",
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
    phase_numerics_selective()


def phase_numerics_selective():
    """zoedepth_k at its default precision (the core in bf16, K1 with the
    bias at N = 769 on the card; the metric head in f32) on the 384 x 512
    image of phase 5, on the card and on the CPU, each held to the card's
    f32 map: the card's drift from it (mean relative difference) within
    SELECTIVE_DRIFT_RATIO times the CPU's."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    from depthmap_tpu_torch.registry import get_default_net_size
    sd = init_random_(build_model(8).module, seed=4).state_dict()
    img = _test_images(5, [(384, 512)])[0].astype(np.float32) / 255.0
    net_w, net_h = get_default_net_size(8)
    maps, launched = {}, {}
    for run, dev, dtype in (("f32", "cuda", torch.float32),
                            ("card", "cuda", None), ("cpu", "cpu", None)):
        pred = DepthPredictor(8, state_dict=sd, device=dev,
                              compute_dtype=dtype, bundle=empty_bundle(8))
        want = (torch.float32, torch.float32 if dtype else torch.bfloat16)
        if (pred.compute_dtype, pred.core_dtype) != want:
            raise AssertionError(
                f"zoedepth_k {run}: ({pred.compute_dtype}, "
                f"{pred.core_dtype}), expected {want}")
        before = fa.flash_attention_cuda.launches
        t0 = time.perf_counter()
        maps[run] = pred.predict(img, net_w, net_h)
        seconds = time.perf_counter() - t0
        launched[run] = fa.flash_attention_cuda.launches - before
        del pred
        torch.cuda.empty_cache()
    ref = np.abs(maps["f32"])
    drift = {run: float((np.abs(maps[run] - maps["f32"]) / ref).mean())
             for run in ("card", "cpu")}
    apart = np.abs(maps["card"] - maps["cpu"]) / np.abs(maps["cpu"])
    log("5-numerics", model="zoedepth_k", precision="selective",
        compute_dtype="torch.float32", core_dtype="torch.bfloat16",
        size="384x512", k1_launches=launched["card"],
        card_drift=f"{drift['card']:.3e}", cpu_drift=f"{drift['cpu']:.3e}",
        ratio=f"{drift['card'] / drift['cpu']:.3f}",
        bound=SELECTIVE_DRIFT_RATIO,
        card_vs_cpu_mean_rel=f"{apart.mean():.3e}",
        card_vs_cpu_max_rel=f"{apart.max():.3e}",
        cpu_seconds=f"{seconds:.1f}")
    if (launched["card"], launched["cpu"]) != (24, 0):
        raise AssertionError(f"zoedepth_k selective: K1 launched "
                             f"{launched}, expected 24 on the card, 0 on "
                             "the CPU")
    if not (all(np.isfinite(m).all() for m in maps.values())
            and drift["cpu"] > 0
            and drift["card"] <= SELECTIVE_DRIFT_RATIO * drift["cpu"]):
        raise AssertionError(f"zoedepth_k selective: the card's drift from "
                             f"the f32 map {drift['card']} > "
                             f"{SELECTIVE_DRIFT_RATIO} x the CPU's "
                             f"{drift['cpu']}")


def _textured(seed: int, h: int, w: int):
    """A float RGB image in [0, 1] with edges everywhere (noise over smooth
    shading): Boost's R_x search keeps climbing on it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = 0.5 + 0.25 * np.stack([np.sin(9 * xx + c) * np.cos(7 * yy - c)
                                 for c in (0.0, 1.0, 2.0)], -1)
    img += 0.15 * rng.normal(size=img.shape)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def drive_boost(phase, name, images, profile=False):
    """One Boost path through PredictorCache and core_generation_funnel
    (boost_rmax 1600): a warm run on the first image, then a timed run of
    each image with every kernel count set to 0 just before it; K1 must
    run 24 times a forward of a BEiT model (two whole-image forwards, two a
    chunk of patches), never for LeReS.  Returns the timed runs' K1
    launches and the last image's R_x."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline.core import (PredictorCache,
                                                  core_generation_funnel)
    inp = GenerationOptions(compute_device="GPU", model_type=name,
                            boost=True)
    ops = {"boost_rmax": 1600}
    cache = PredictorCache()
    list(core_generation_funnel(None, images[:1], None, None, inp, ops,
                                cache))
    launches = 0
    for image in images:
        h, w = image.shape[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        out = list(core_generation_funnel(None, [image], None, None, inp,
                                          ops, cache))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1 = fa.flash_attention_cuda.launches
        engine = cache._boost
        run = engine.last_run
        blocks = backbone_shape(engine.predictor.bundle.module)[0]
        want = blocks * (2 + 2 * run["chunks"])
        d = out[0][2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(phase, model=name, size=f"{h}x{w}", rf=engine.rf,
            R_x=run["whole_size"], patches=run["patches"],
            chunks=run["chunks"], s_per_image=f"{seconds:.3f}",
            k1_launches=k1, k1_expected=want,
            max_memory_allocated_GiB=f"{peak:.3f}",
            dtype=str(engine.predictor.compute_dtype))
        if [t for _, t, _ in out] != ["depth"] or d.dtype != np.uint16 or \
                d.shape != (h, w) or int(d.max()) - int(d.min()) <= 0:
            raise AssertionError(f"{phase} {name}: outputs {out}")
        if k1 != want:
            raise AssertionError(f"{phase} {name}: K1 launched {k1} times, "
                                 f"expected {want}")
        launches += k1
        if profile:
            profile_paths(cache, inp, [(f"{phase}_{name}_{h}x{w}", [image])],
                          ops)
    cache.release()
    torch.cuda.empty_cache()
    return launches, run["whole_size"]


def phase_boost(profile: bool = False):
    """Boost at r_max 1600 on res101 (1080p and 4:3) and on
    dpt_beit_large_512 (a textured 4:3 image: R_x 1536, N = 6913); then the
    device chain and pix2pix, card against CPU."""
    os.environ["DEPTHMAP_ALLOW_RANDOM_PIX2PIX"] = "1"
    drive_boost("13-boost", "res101",
                [_test_images(13, [(1080, 1920)])[0],
                 _test_images(14, [(768, 1024)])[0]], profile)
    k1, whole = drive_boost("13-boost", "dpt_beit_large_512",
                            [_textured(15, 768, 1024)], profile)
    if whole != 1536:
        raise AssertionError(f"BEiT's Boost ran its whole image at R_x "
                             f"{whole}, not 1536")
    phase_boost_numerics()
    return k1


def phase_boost_numerics():
    """Boost's device chain at 1080p with P = 1024 (crops of the image and
    of the frame, the fit, the blend with the 3000^2 mask) and the
    full-width pix2pix (1024^2, batch 1, f32), card against the port's
    CPU."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.pix2pix import build_pix2pix
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline import boost as B
    from depthmap_tpu_torch.pipeline.depth import set_fp32_precision
    set_fp32_precision(torch.device("cuda"))
    rng = np.random.default_rng(16)
    img = _textured(16, 1080, 1920).astype(np.float32) / 255.0
    rects = np.asarray(B.select_patches(img, 448, 1600, 1.0, 1600)[:4] +
                       [(0, 0, 0, 0)], np.int32)
    frame = rng.random((1080, 1920)).astype(np.float32)
    merged = rng.random((len(rects), 1024, 1024)).astype(np.float32)
    errs, ms = {}, {}
    out = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in
             (("img", img), ("frame", frame), ("merged", merged))}
        mask = B.generate_mask(B.MASK_SIZE, dev)
        crops = B.crop_resize_batch(t["img"], rects, 1024, 1024)
        base = B.crop_resize_batch(t["frame"], rects, 1024, 1024)
        fit = B.fit_to_base(t["merged"], base)
        blend = B.blend_patches(t["frame"], fit, rects, mask)
        out[dev] = {"crops": crops, "base": base, "fit": fit,
                    "blend": blend}
        if dev == "cuda":
            ms["crop_4x1024"] = cuda_ms(lambda: B.crop_resize_batch(
                t["img"], rects, 1024, 1024), 3)
            ms["blend"] = cuda_ms(lambda: B.blend_patches(
                t["frame"], fit, rects, mask), 3)
    for k in out["cpu"]:
        errs[k] = float((out["cuda"][k].cpu() - out["cpu"][k]).abs().max())
    net = init_random_(build_pix2pix(), seed=6)
    a, b = (torch.from_numpy(rng.random((1, 1024, 1024)).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        want = net(a, b)
        card = net.cuda()
        got = card(a.cuda(), b.cuda())
        torch.cuda.synchronize()
        ms["pix2pix"] = cuda_ms(lambda: card(a.cuda(), b.cuda()), 3)
    span = float(want.max() - want.min())
    errs["pix2pix"] = float((got.cpu() - want).abs().max())
    log("13-boost-numerics", rects=len(rects) - 1,
        **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()},
        chain_tol=BOOST_CHAIN_TOL, pix2pix_range=f"{span:.4f}",
        pix2pix_tol=f"{PATH_RTOL} x range",
        **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()})
    bad = [k for k, v in errs.items() if k != "pix2pix"
           and not v <= BOOST_CHAIN_TOL]
    if bad or not (span > 0 and errs["pix2pix"] <= PATH_RTOL * span):
        raise AssertionError(f"Boost card vs CPU: {errs}")
    del card, net
    torch.cuda.empty_cache()


def drive_marigold(phase, image, state_dict, profile=False):
    """Marigold through the funnel at res 768, ensemble 5, 12 steps, in
    the dtype DEPTHMAP_MARIGOLD_DTYPE names: a warm run, then a timed one
    with the K1 count set to 0 just before it: 32 launches a UNet forward,
    384 an image."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline.core import (PredictorCache,
                                                  core_generation_funnel)

    bundle = empty_bundle(10)

    class Cache(PredictorCache):       # the same random weights each dtype
        def get(self, model_type, tiling_mode=False, **kw):
            return super().get(model_type, tiling_mode, bundle=bundle,
                               state_dict=state_dict, **kw)
    inp = GenerationOptions(compute_device="GPU", model_type=10,
                            net_width=768, net_height=768)
    ops = {"marigold_ensembles": 5, "marigold_steps": 12}
    cache = Cache()
    h, w = image.shape[:2]
    t0 = time.perf_counter()
    list(core_generation_funnel(None, [image], None, None, inp, ops, cache))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pred = cache._predictor
    # the dtype the UNet's first self-attention computes in: f32 in both
    # modes (flax's promotion, which the port's layers follow)
    attn_dtypes = set()
    hook = pred.bundle.module.unet.down_blocks[0].attentions[0] \
        .transformer_blocks[0].attn1.register_forward_hook(
            lambda m, i, o: attn_dtypes.add(str(o.dtype)))
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    out = list(core_generation_funnel(None, [image], None, None, inp, ops,
                                      cache))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = fa.flash_attention_cuda.launches
    hook.remove()
    d = out[0][2]
    log(phase, size=f"{h}x{w}", res=768, ensemble=5, steps=12,
        dtype=str(pred.compute_dtype), attention_dtype=sorted(attn_dtypes),
        s_warm=f"{warm_s:.3f}", s_per_image=f"{seconds:.3f}",
        k1_launches=k1,
        max_memory_allocated_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if d.dtype != np.uint16 or d.shape != (h, w) or \
            int(d.max()) - int(d.min()) <= 0:
        raise AssertionError(f"{phase}: depth {d.dtype} {d.shape}")
    if attn_dtypes != {"torch.float32"}:
        raise AssertionError(f"{phase}: the UNet's attention ran in "
                             f"{attn_dtypes}, not in f32 as the JAX "
                             "package's promotion runs it")
    if k1 != 32 * 12:
        raise AssertionError(f"{phase}: K1 launched {k1} times, expected "
                             "384 (32 a UNet forward, 12 steps)")
    if profile:
        profile_paths(cache, inp, [(f"{phase}_{pred.compute_dtype}",
                                    [image])], ops)
    cache.release()
    del pred, cache, Cache, bundle
    gc.collect()    # the class above sits in a cycle (super's cell)
    torch.cuda.empty_cache()
    return k1


def phase_marigold(profile: bool = False):
    """Marigold v1 at full width (random weights from a seed) on a 4:3
    image, f32 then bf16; then card against CPU at processing_res 64."""
    import torch
    from depthmap_tpu_torch.models.marigold.pipeline import build_marigold
    from depthmap_tpu_torch.models.weights import init_random_
    t0 = time.perf_counter()
    sd = init_random_(build_marigold(), seed=4).state_dict()
    log("14-marigold", weights=len(sd),
        params_M=f"{sum(t.numel() for t in sd.values()) / 1e6:.1f}",
        init_s=f"{time.perf_counter() - t0:.2f}")
    image = _test_images(17, [(768, 1024)])[0]
    launches = {}
    for dtype in ("float32", "bfloat16"):
        os.environ["DEPTHMAP_MARIGOLD_DTYPE"] = dtype
        launches[dtype] = drive_marigold("14-marigold", image, sd, profile)
    os.environ.pop("DEPTHMAP_MARIGOLD_DTYPE")
    phase_marigold_numerics(sd)
    return launches


def phase_marigold_numerics(sd):
    """The full-width nets at processing_res 64 (a 48 x 64 input, latent 6
    x 8), ensemble 2, 2 steps, the same noise, f32: the members before the
    ensemble, card (K1) against CPU (the plain version), to PATH_RTOL of
    the CPU map's range."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.pipeline.depth import set_fp32_precision
    set_fp32_precision(torch.device("cuda"))
    img = _test_images(18, [(48, 64)])[0].astype(np.float32) / 255.0
    rgb = torch.from_numpy(img).permute(2, 0, 1)[None].expand(2, -1, -1, -1)
    noise = torch.randn((2, 4, 6, 8),
                        generator=torch.Generator().manual_seed(18))
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = empty_bundle(10).module
        pipe.load_state_dict(sd)
        pipe = pipe.to(dev).eval()
        before = fa.flash_attention_cuda.launches
        t0 = time.perf_counter()
        out[dev] = pipe.single_infer(rgb.to(dev), 2, noise).cpu()
        out[dev + "_s"] = time.perf_counter() - t0
        out[dev + "_k1"] = fa.flash_attention_cuda.launches - before
        del pipe
        torch.cuda.empty_cache()
    span = float(out["cpu"].max() - out["cpu"].min())
    err = float((out["cuda"] - out["cpu"]).abs().max())
    log("14-marigold-numerics", res=64, ensemble=2, steps=2,
        k1_launches=out["cuda_k1"], cpu_range=f"{span:.4e}",
        max_abs_diff=f"{err:.4e}", bound=f"{PATH_RTOL} x range",
        cpu_seconds=f"{out['cpu_s']:.1f}")
    if (out["cuda_k1"], out["cpu_k1"]) != (64, 0):
        raise AssertionError(f"Marigold numerics: K1 launched "
                             f"{out['cuda_k1']} / {out['cpu_k1']} times, "
                             "expected 64 on the card, 0 on the CPU")
    if not (span > 0 and err <= PATH_RTOL * span):
        raise AssertionError(f"Marigold card vs CPU: {err} > {PATH_RTOL} x "
                             f"{span}")


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out
    smi = timed("0", phase_environment)
    timed("1", phase_build)
    k1_err, k1 = timed("2", phase_k1)
    k2_err, k2 = timed("3", phase_k2)
    k1_by_path = {}
    k1_by_path["dpt_beit_large_512"], k2_launches = timed(
        "4", phase_main_path, profile)
    timed("5", phase_numerics)
    k1_by_path["default_options_da_v2_base"], _ = timed(
        "6", phase_default_options, profile)
    k1_by_path["long_n_da_v2_large"], _ = timed("7", phase_long_n, profile)
    timed("8", phase_warp_fills, k2["ms"])
    k1_by_path["dpt_large_384"] = timed("9", phase_dpt_large, profile)
    k1_by_path.update(timed("10", phase_zoo, profile))
    k1_by_path.update(timed("12", phase_metric_zoo, profile))
    timed("11", phase_normalmap)
    k1_by_path["boost_dpt_beit_large_512"] = timed("13", phase_boost,
                                                   profile)
    k1_by_path.update({f"marigold_{dt}": n for dt, n in timed(
        "14", phase_marigold, profile).items()})
    log("phases", seconds=seconds)
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
