#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one CUDA card.

    python3 chip_smoke.py             # the smoke test
    python3 chip_smoke.py --profile   # and a device-time breakdown
    python3 chip_smoke.py --profile --phase 13,19   # those phases alone

Phases (each prints one line with its numbers; any failure exits non-zero
and prints no result):
  0. environment: CUDA required; torch / CUDA versions, the card's name
     and power limit from nvidia-smi, whether PIL and cv2 import;
  1. build: nvcc builds both hand-written kernels from csrc/ and g++ the
     host polylines kernel (in parallel); ptxas's register / spill report
     of each kernel (a K1 kernel that spills fails) and K1's shared
     memory and CTAs an SM per body and mode (the bf16 body must hold
     K1_BF16_CTAS in each); per kernel of K1's SASS its HGMMA (wgmma)
     instructions: the bf16 kernel must hold some, the f32 kernel some on
     TF32 operands and at most K1_F32_MAX_FFMA FFMA (no product on the
     CUDA cores);
  2. K1 (flash attention) against its plain version at the model paths'
     shapes, bf16 and f32 (split TF32: three TF32 passes a product), with a
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
     version's, SDPA's on the same tensors, both ways (the efficient,
     flash and cuDNN backends, each where it takes the case, "refused"
     where not; the port never calls any), the bound and the share of
     it (f32: also the split-TF32 bound), and the error of three planted
     faults (a kv tile skipped, the output scaled), each of which must
     exceed the bound; f32 cases must also hold K1_F32_ACCURACY, which one
     TF32 pass (a fourth fault) must break; K1's table mode (BEiT's
     streamed tier: the bias read from the (H, T) rel-pos table inside the
     kernel) at Boost's, net 1600's and net 2048's shapes in bf16 (N =
     3073 to 16385) and net 768 and 1024 in f32, each byte-equal to K1
     with the bias materialized from the same table and within the K1
     bound of the plain streamed version, which two planted faults (gh
     and gw swapped on a grid that is not square, the cls entries
     swapped) must break; with the materialized call's time (and table
     mode's share of it), the bias-free body's at the same shape (the
     floor), the gather's, SDPA's (efficient, cuDNN) with the
     materialized bias and the operations bound; then ("2a") the bf16
     body's
     rescale at N = 10765 (K1_ALPHA_*): its signed mean error against f64
     over all rows within K1_ALPHA_SIGMAS standard errors of 0, the old
     alpha form's (restated) outside, beside the plain version's;
  3. K2 (polylines) against its plain version, byte-exact: at 1080x1920,
     4 cases on a random depth map (sharp +24 and -48 px, soft -24 and +48;
     the timed one: sharp, +24 px) and one timed case on a smooth map,
     like the main path's; at 512x512 (the
     main path's other eyes), sharp at its +-6.4 px, random and smooth;
     each stage's time (the sort, the sweep), the sweep's steps per row
     and its time per step, and the bound;
  4. main path, MAIN_RUNS timed runs: dpt_beit_large_512 at full width
     (24 blocks, 1024 wide, random init from a seed, bf16) through
     PredictorCache and core_generation_funnel: 4 images of 512x512
     (one chunk) and one of 1920x1080 (a chunk of one, inline
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
     at N = 1025 (the 512^2 chunk) and 1825 (1080p), 12 launches per
     forward;
  7. long N, 2 timed runs: Depth Anything v2 Large (24 blocks, 1024 wide)
     with net_size_match on one 1920x1080 image, depth only: N = 10765,
     24 K1 launches;
  8. the warp stereo fills (none, naive, naive_interpolating) at
     1080x1920, exponent 1 and 1.7, card against CPU byte for byte, ms
     per eye beside K2's;
  9. this slice's path, MAIN_RUNS timed runs: dpt_large_384 at full width
     (ViT-L/16: 24 blocks, 1024 wide, 16 heads, bf16) on the images of
     phase 4 at net 384 with depth, normal map and heatmap: K1 at N = 577
     (the 4 x 512^2 chunk) and 1009 (1080p), 24 launches a forward;
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
     whole-image forwards and two a chunk of 4 patches), by mode: BEiT's
     forwards over the stream budget (the whole image at 1536, the
     patches at 1024^2) in table mode, no bias gathered; then the device
     chain (crop-resize, fit, blend) at 1080p with P = 1024 and the
     full-width pix2pix (1024^2, batch 1, f32), card against CPU;
 14. Marigold (type 10) through the funnel: a 4:3 image at res 768
     (latent 96 x 72), ensemble 5, 12 steps, in f32 (its default) and in
     bf16 (DEPTHMAP_MARIGOLD_DTYPE: bf16 weights, the VAE in bf16, the
     UNet in f32 past its first time-embedding add, the attention's
     dtype logged), one warm and one timed run each: K1 32
     times a UNet forward, 384 an image, all in its f32 body (counted by
     dtype); s per image, peak memory; then the
     full-width nets at processing_res 64, ensemble 2, 2 steps, the same
     noise, f32, card against CPU (the members before the ensemble).
 15. video mode through gen_video: GenerationOptions() (DA v2 Base, net
     448) with polylines_sharp stereo on 20 textured 1920 x 1080 PNG
     frames: pass 1 in chunks of 8 (the tail of 4 its own batch, 36 K1
     launches), pass 2 with the maps injected (no K1; K2's sort and sweep
     once per eye, 40 each), the depth AVI and the stereo GIFs written;
     pass 1's frames / s, pass 2's s per frame, the writes, peak memory;
     then pass 1's maps equal to predict_batch chunk by chunk;
 16. the 3D photo through core_generation_funnel (GenerationOptions(),
     gen_inpainted_mesh) on one textured 768 x 1024 image, from a working
     directory whose models/3dphoto holds seeded full-width checkpoints
     (the edge net's spectral norm as weight_orig / _u / _v): 12 K1
     launches, the inpainting nets' calls on the card, an OBJ of at least
     H x W vertices; the ms of the filter, the LDI's host work, the nets
     and the write; then the funnel's 4 demo trajectories at 30 frames
     each (the funnel runs 300), render and footprint ms per frame and K,
     and one run_makevideo at vid_ssaa 3 over 4 frames; card against CPU:
     the weighted median (equal), each net on one crop (NET_RTOL of the
     range), one rendered frame (99.9% of the pixels equal, |d| <= 2).
 17. the REST server (frontends/api.py make_server on a thread of this
     process), random weights from seed 0: /depth/version and
     /depth/get_options; POST /depth/generate with phase 4's images on
     dpt_beit_large_512 + polylines_sharp stereo, then the default options
     (DA v2 Base) on the 1080p image, each request's PNGs byte-equal to a
     direct core_generation_funnel call and its K1 / K2 launches equal to
     the direct call's (48 and 10 + 10; 12), with s per request and peak
     memory; /depth/generate/video on one 512^2 image (the 3D photo from
     seeded checkpoints, a REST_VIDEO_FRAMES-frame GIF); the 422 / 400 /
     404 / 413 routes; the default-options request through `python -m
     depthmap_tpu_torch.cli --serve` in a process of its own (its PNGs
     equal, the process stopped); the UI's run_generate on BEiT + stereo
     (24 K1 launches); the host polylines kernel byte-equal to K2 on a
     1080p eye and to polylines_plain at 270 x 480, with each one's ms;
 18. parallel/, the train step and the graft entry: (a) K1's gradient
     (FlashAttentionFunction: K1's forward, the backward in torch) at the
     train step's (2, 16, 1025) with a shared bias that requires grad and
     at (4, 12, 1025) bias-free, f32: dq, dk, dv, dbias against autograd
     in f64 within K1_GRAD_BOUND, which a detached output (the parent's)
     and a backward without its rowsum term each break, and the
     backward's ms beside the forward's; (d) entry()'s forward (BEiT-L
     512, f32, 24 K1 launches, a finite map); (b) the train step on that
     model at full width: a (1, 1) mesh over NCCL at world 1, Adam 1e-4,
     2 x 512^2, TRAIN_STEPS steps, each a finite loss and 24 K1 f32
     launches, step 1's loss and gradients against the same step with
     attention through the plain version (TRAIN_*_RTOL), the rel-pos
     tables', qkv's, q_bias's and v_bias's gradients non-zero, s per step
     and peak memory; (c) each split forced over [cuda:0, cuda:0] against
     its unsplit run, with both ms: predict_batch (BEiT-L 512 bf16, 4 x
     512^2, 48 K1 launches; byte-equal to its shards run unsplit, within
     SPLIT_BF16_* of the whole batch), Boost on a textured 384 x 512
     image at r_max 1024 (SPLIT_BOOST_ATOL), Marigold's members at res 64, ensemble 4, 2
     steps, f32 (byte-equal to its shards, within SPLIT_MARIGOLD_ATOL of
     the whole), K2's rows on phase 3's 1080p eye (byte-equal, 2 sorts
     and 2 sweeps); (d) dryrun_multichip(2) on the CPU (gloo).  Every K1
     shape of 18b-18d (table mode's with its grid) must be a phase-2
     case.  One card: cross-card NCCL is not measured;
 19. streamed bias: dpt_beit_large_512 (bf16) through the predictor at
     net 1024^2, 1600^2 and 2048^2, in the streamed tier and in the
     inline one (DEPTHMAP_BIAS_STREAM_BYTES raised): the maps byte-equal,
     each forward's ms, peak memory and K1 launches by mode (24 table-mode
     launches streamed, 24 with a materialized bias inline); at 2048^2
     the streamed peak under one block's 8.6 GB bias, the inline one
     over it.
Each model path (4, 6, 7, 9, 10, 12, 13, 14, 15, 16, 17, 18, 19) sets
every kernel count to 0 just before each timed run and reads it just
after.  With
--profile, torch.profiler over one warm funnel run per path (video mode:
one gen_video; the 3D photo: one funnel run and 4 demo frames; phase 19:
one streamed forward at 2048^2) gives each path's device time and K1's /
K2's share of it (K2: both stages).  Each profile must have seen every
launch of K1 and of K2's stages that the wrappers counted over it; the
phase of a profile that lost one is profiled again in a fresh process
(``--phase``) at the end, where a loss fails.  ``--phase A,B``
runs the environment, the build and those phases alone (those that
profile and need no earlier phase: STANDALONE_PHASES) and prints no
result lines.  The
last lines: the card's name and power limit, a JSON line with each
kernel's numbers (K1's launches: the sum over the model paths, each
path's count beside it, the f32 body's on the Marigold paths, the table
mode's on the paths that stream (launches_rel_by_path) and its main case
(Boost's (1, 16, 6913), table_mode), and the f32 body's main case,
Marigold's (5, 5, 6912), with SDPA efficient's time and both bounds, and the rescale check's signed mean; K2's: the sweeps of
phases 4, 15's pass 2 and 17, each beside it), and {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import ctypes
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from importlib import util as importlib_util

# K1 bounds against the plain version (max abs error).  f32: the bound the
# JAX package holds its TPU kernel to.  bf16: the output is rounded to
# bf16 (one ulp is 2^-8 relative, 7.8e-3 at |x| in [1, 2)) and p is
# rounded to bf16 before p.v, so a different f32 summation order can flip
# one rounding of each; 2e-2 is about two output ulps at the largest
# outputs of these inputs.
K1_BOUND = {"float32": 5e-3, "bfloat16": 2e-2}
# f32 cases must also agree with the plain version to f32 accuracy: the
# split-TF32 body errs 1-4e-6 at these inputs, as the f32 plain version
# does against f64, and one TF32 pass (10 mantissa bits) 1e-3 or more,
# which the 5e-3 bound would let pass.  The tf32_one_pass fault holds the
# line.
K1_F32_ACCURACY = 5e-5
# the f32 body's main case: Marigold's largest self-attention
K1_F32_MAIN = "f32_b5_h5_n6912_self"
# table mode's main case: Boost's whole image at R_x 1536 (phase 13)
K1_REL_MAIN = "bf16_b1_h16_n6913_rel72x96"
# table mode's tables ~ this x N(0, 1): a spread of a few units, so that a
# wrong index (a swapped grid, swapped cls entries) moves the logits as
# much as q.k does
K1_REL_TABLE_STD = 3.0
# K1's bf16 body, in each mode: CTAs an SM (its 64-row CTAs measured
# fastest three to an SM; table mode's larger bias slot keeps three)
K1_BF16_CTAS = 3
# K1's f32 kernel in SASS: at most this many FFMA, 5 for each of the 32
# scores a thread holds per tile.  The softmax needs two a score (the
# scale or bias, the move to log2 space), O = O.alpha + tile one an output
# element (32 a thread), the row sums and the epilogue's divisions a few
# more.  A product on the CUDA cores needs D = 64 a score (the CUDA-core
# body this one replaced held 599 FFMA in SASS).
K1_F32_MAX_FFMA = 160
# K1's inputs: q ~ 4 N(0, 1), k ~ N(0, 1), v ~ N(0, 1) / 4.  The logits
# (D = 64, scale 1/8) have std 4, so the softmax is peaked and an output
# is a mix of a few values of v (at most ~1.4), far above the bound where
# a kernel errs.  With std-1 logits the softmax is nearly flat and the
# outputs' RMS is sqrt(e / Nk), 0.016 at Nk = 10765: under the bf16 bound.
K1_Q_SCALE, K1_V_SCALE = 4.0, 0.25
# K1's rescale check (bf16 body, N = 10765: 169 kv tiles).  Every row's max
# sits in the first tile at the same logit: q[..., 0] = 1, key 0 is
# (K1_ALPHA_KEY, 0, ..., 0) and every other key is 0 there, so the max is
# K1_ALPHA_KEY / 8 = 11.25 in every row (the other logits have std 1.5);
# v rises with the key index (-1 to 1, plus N(0, 0.1) a column).  An alpha
# that is not 1 while the max holds reweights the earlier tiles once a
# tile, the same way in every row (~6e-7 a tile at this logit), so the
# signed mean error against f64 over all rows drifts one way; bf16
# rounding has no such mean.  So does one P.V accumulator over every tile,
# since the tensor cores' sums round toward zero.  The kernel's signed mean
# must lie within K1_ALPHA_SIGMAS standard errors of 0 (each row's mean
# over D one sample), and the answer of the old form (the online softmax
# restated tile by tile with alpha = ex2(m.log2e + nml)) must lie outside.
# Measured on the H100 at these inputs (standard error 3.4e-7): the plain
# version 1.0 standard errors, the restated new form 2.4, the kernel with
# both repairs 3.8; the restated old form 42, the kernel with the old
# alpha 12, with the new alpha but one accumulator 57.
K1_ALPHA_N = 10765
K1_ALPHA_KEY = 90.0
K1_ALPHA_SIGMAS = 6.0
K1_SOURCE = "depthmap_tpu_torch/csrc/flash_attention.cu"
# a fragment of the names of K1's two bodies (flash_fwd_bf16 / _f32)
K1_KERNEL = "flash_fwd"
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


def _bench_peaks() -> dict:
    """port_bench/peaks.py's table, loaded from beside this file by its
    path: the timing tools load this file with another tree first on
    sys.path."""
    spec = importlib_util.spec_from_file_location(
        "port_bench_peaks", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "port_bench", "peaks.py"))
    mod = importlib_util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PEAKS


# One H100 SXM at its 700 W limit, the benchmark's peaks: memory bytes/s,
# bf16 and TF32 tensor-core and f32 CUDA-core flop/s
PEAK_FLOPS = _bench_peaks()["H100 80GB HBM3"]
HBM_BPS = PEAK_FLOPS["hbm_bps"]


# what a later phase reuses: phase 3's timed eye, phase 14's weights
_KEEP = {}
# --profile: the phase running, and the phases whose profiles lost a
# launch, profiled again in a fresh process at the end of a full run
# (None in a --phase run or a tool that imports profile_call: a lost
# launch fails there)
_PROFILE = {"phase": None, "again": None}


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


def _annotation(event) -> bool:
    """Whether a profiler event is a user annotation's range (a
    ``record_function`` span, e.g. utils/profiling.py ``stage``), which
    the profiler also lists on the device, over every kernel inside it:
    not a kernel's time (torch's own device-time sum skips them too)."""
    return bool(getattr(event, "is_user_annotation", False))


# spin cycles that hold the stream while the host queues the calls
# device_ms times (~10 ms on an H100's clock), doubled while too short
HOLD_CYCLES = 20_000_000


def device_ms(fn, iters: int, tries: int = 4) -> float:
    """The device time of one call of ``fn``: CUDA events around ``iters``
    calls (after a warm one) queued behind a spin kernel that holds the
    stream until the host has queued them all, so no launch gap of the
    host enters; per call.  The hold must outlast the queueing (the end
    event still pending once it is queued), else it is doubled, ``tries``
    times in all.  ``cuda_ms`` times the same calls as a caller sees them,
    host gaps included.  (torch.profiler, which sums kernel times, lost
    one launch in five after the first dozen cases of phase 2 on the H100,
    so it times nothing here.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold = HOLD_CYCLES
    for _ in range(tries):
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not end.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        hold *= 2
    raise AssertionError(f"device_ms: the host took longer to queue {iters} "
                         f"calls than a {hold // 2}-cycle spin")


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
    # one nvcc per source and g++ for the host polylines kernel, together
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda f: f(), (fa._lib, pl._lib,
                                             pl._host_lib)))
    log("1-build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_kernel={k: round(v, 2) for k, v in
                    cuda_build.build_seconds.items()},
        host_kernel=os.path.basename(libs[2]._name))
    for name, text in cuda_build.build_logs.items():
        fn = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log("1-ptxas", lib=name, kernel=short_name(fn),
                    info=repr(line.strip()))
                if name == "flash_attention" and "spill" in line and \
                        " 0 bytes spill stores, 0 bytes spill loads" \
                        not in line:
                    raise AssertionError(f"K1's {short_name(fn)} spills: "
                                         f"{line.strip()}")
    lib = libs[0]
    lib.flash_attention_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    ctas = {(dt, mode): lib.flash_attention_ctas_per_sm(dt, mode)
            for dt in (0, 1) for mode in (0, 1)}
    log("1-smem", lib="flash_attention",
        f32_bytes=lib.flash_attention_smem_bytes(0, 0),
        bf16_bytes=lib.flash_attention_smem_bytes(1, 0),
        bf16_table_mode_bytes=lib.flash_attention_smem_bytes(1, 1),
        ctas_per_sm={f"{'f32' if dt == 0 else 'bf16'}"
                     f"{'_rel' if mode else ''}": n
                     for (dt, mode), n in ctas.items()})
    # the bf16 body holds K1_BF16_CTAS CTAs an SM in every mode
    if min(ctas[(1, 0)], ctas[(1, 1)]) < K1_BF16_CTAS or \
            min(ctas[(0, 0)], ctas[(0, 1)]) < 1:
        raise AssertionError(f"K1's CTAs an SM: {ctas}")
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", libs[0]._name],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = k1_sass_counts(sass)
    for kernel, c in counts.items():
        log("1-sass", lib="flash_attention", kernel=kernel, **c)
    for mode in ("", "_rel"):   # each body's two instances
        bf16 = counts.get("flash_fwd_bf16" + mode)
        f32 = counts.get("flash_fwd_f32" + mode)
        if not bf16 or bf16["HGMMA"] == 0:
            raise AssertionError(f"no HGMMA instruction in K1's bf16{mode} "
                                 "kernel: it does not run on the tensor "
                                 "cores")
        if not f32 or f32["HGMMA_TF32"] == 0:
            raise AssertionError(f"no TF32 HGMMA instruction in K1's "
                                 f"f32{mode} kernel: it does not run on "
                                 "the tensor cores")
        if f32["FFMA"] > K1_F32_MAX_FFMA:
            raise AssertionError(f"K1's f32{mode} kernel holds "
                                 f"{f32['FFMA']} FFMA (> {K1_F32_MAX_FFMA}):"
                                 " a product on the CUDA cores")


def short_name(mangled):
    """The kernel's name inside a mangled symbol (the csrc kernels live in
    an anonymous namespace); K1's table-mode instances (template argument
    true, "ILb1E") end in "_rel"."""
    for name in ("flash_fwd_bf16", "flash_fwd_f32", "split_kv_f32",
                 "polylines_sort", "polylines_sweep"):
        if mangled and name in mangled:
            return name + "_rel" if name + "ILb1E" in mangled else name
    return mangled


def k1_sass_counts(sass: str):
    """Per kernel of K1's library: its HGMMA instructions, those on TF32
    operands, its FFMA, and its first HGMMA line."""
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = short_name(part.split(None, 1)[0])
        lines = part.splitlines()
        hgmma = [ln.strip() for ln in lines if "HGMMA" in ln]
        counts[name] = {
            "HGMMA": len(hgmma),
            "HGMMA_TF32": sum("TF32" in ln for ln in hgmma),
            "FFMA": sum(" FFMA" in ln for ln in lines),
            "first_HGMMA": repr(hgmma[0][:96]) if hgmma else None}
    return counts


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
    # DA v2 Base (net 448) in video mode's pass 1 on 1080p frames: chunks
    # of 8 and the tail of 4 (448 x 798: N = 1825); the 3D photo's one
    # 4:3 image (768 x 1024 -> 448 x 602: 32 x 43 + 1)
    ("bf16_b8_h12_n1825_none", "bfloat16", 8, 12, 1825, None),
    ("bf16_b4_h12_n1825_none", "bfloat16", 4, 12, 1825, None),
    ("bf16_b1_h12_n1377_none", "bfloat16", 1, 12, 1377, None),
    # phase 18: the train step's forward (BEiT-L 512 in f32, batch 2);
    # Boost's whole image at R_x 1024 on the 4:3 input (1024 x 768: 64 x
    # 48 + 1); Marigold at res 64 on a 4:3 input (latent 8 x 6: levels of
    # 48, 12, 4 and 1 tokens), its members split over two devices (batch
    # 2) and unsplit (4), f32.  Phase 18 fails on a K1 shape of its paths
    # that is not a case here (``k1_shapes``).
    ("f32_b2_h16_n1025_shared", "float32", 2, 16, 1025, 1),
    ("bf16_b1_h16_n3073_shared", "bfloat16", 1, 16, 3073, 1),
    # K1's table mode (the bias field ("rel", gh, gw)): BEiT-L 512's
    # streamed tier, one block's bias over DEPTHMAP_BIAS_STREAM_BYTES
    # (bf16 from N = 2897, f32 from 2049): Boost's whole image at R_x
    # 1024 on a 4:3 input (phase 18c), its patches at 1024^2, its whole
    # image at R_x 1536 on a 4:3 input (phase 13) and on a square one, the
    # whole image at r_max 1600, net 2048 (phase 19, with 1024 and 1600);
    # net 768 and 1024 in f32; a thin grid whose windows span many grid
    # rows (3 x 200).  A table-mode row also holds K1 with the
    # materialized bias at its shape (bias batch 1), byte-equal to it:
    # the inline tier of phase 19
    ("bf16_b1_h16_n3073_rel48x64", "bfloat16", 1, 16, 3073, ("rel", 48, 64)),
    ("bf16_b4_h16_n4097_rel64x64", "bfloat16", 4, 16, 4097, ("rel", 64, 64)),
    ("bf16_b1_h16_n4097_rel64x64", "bfloat16", 1, 16, 4097, ("rel", 64, 64)),
    ("bf16_b1_h16_n6913_rel72x96", "bfloat16", 1, 16, 6913, ("rel", 72, 96)),
    ("bf16_b1_h16_n9217_rel96x96", "bfloat16", 1, 16, 9217, ("rel", 96, 96)),
    ("bf16_b1_h16_n10001_rel100x100", "bfloat16", 1, 16, 10001,
     ("rel", 100, 100)),
    ("bf16_b1_h16_n16385_rel128x128", "bfloat16", 1, 16, 16385,
     ("rel", 128, 128)),
    ("f32_b1_h16_n2305_rel48x48", "float32", 1, 16, 2305, ("rel", 48, 48)),
    ("f32_b1_h16_n4097_rel64x64", "float32", 1, 16, 4097, ("rel", 64, 64)),
    ("bf16_b1_h16_n601_rel3x200", "bfloat16", 1, 16, 601, ("rel", 3, 200)),
    *[(f"f32_b{b}_h{h}_n{n}_{kind}", "float32", b, h, n, None,
       *((77,) if kind == "cross77" else ()))
      for b in (2, 4) for kind in ("self", "cross77")
      for h, n in ((5, 48), (10, 12), (20, 4), (20, 1))],
]


def k1_case_key(dtype: str, b, h, n, nk, bias_batch) -> tuple:
    """A K1 call's shape: (dtype, B, H, N, Nk, bias batch, None or, in
    table mode, ("rel", gh, gw))."""
    return (dtype, b, h, n, nk, bias_batch)


class k1_shapes:
    """Inside: ``seen`` gathers the shape (``k1_case_key``) of every K1
    launch, table mode's with its grid, for the check that phase 2 held
    each against the plain version.  Records, launches nothing."""

    def __enter__(self):
        from depthmap_tpu_torch.ops import flash_attention as fa
        self.orig, self.seen = fa._launch, set()

        def record(q, k, v, bias, table, grid, scale):
            mode = ("rel", *grid) if table is not None else \
                None if bias is None else bias.shape[0]
            self.seen.add(k1_case_key(str(q.dtype)[6:], *q.shape[:3],
                                      k.shape[2], mode))
            return self.orig(q, k, v, bias, table, grid, scale)
        fa._launch = record
        return self

    def __exit__(self, *exc):
        from depthmap_tpu_torch.ops import flash_attention as fa
        fa._launch = self.orig


def k1_shapes_not_held(seen) -> list:
    """The shapes in ``seen`` that no K1_CASES row holds (a table-mode row
    holds its shape in table mode and with the materialized bias, which
    k1_rel_case requires byte-equal)."""
    held = set()
    for _, dt, b, h, n, bb, *rest in K1_CASES:
        held.add(k1_case_key(dt, b, h, n, rest[0] if rest else n, bb))
        if isinstance(bb, tuple):
            held.add(k1_case_key(dt, b, h, n, n, 1))
    return sorted(seen - held, key=str)


def check_k1_shapes(phase: str, seen) -> None:
    """Log the K1 shapes a phase ran and fail on one that phase 2 does not
    hold against the plain version."""
    missing = k1_shapes_not_held(seen)
    log(f"{phase}-k1-shapes", seen=len(seen), not_in_phase_2=missing)
    if missing:
        raise AssertionError(f"{phase}: K1 ran at shapes phase 2 does not "
                             f"hold against the plain version: {missing}")


def k1_bound(b, h, n, nk, bias_batch, dtype):
    """K1's bound: q, k, v, out and the bias's N x Nk entries moved once
    (table mode: the (H, T) f32 table, no bias); 4.B.H.N.Nk.D flops at the
    dtype's peak.  For f32 also the split-TF32 bound (three TF32 passes a
    product, the work the f32 body does on the tensor cores): ((ms, basis)
    of the dtype, that or None)."""
    item = 2 if dtype == "bfloat16" else 4
    if isinstance(bias_batch, tuple):   # the f32 table
        _, gh, gw = bias_batch
        bias_bytes = 4 * h * ((2 * gh - 1) * (2 * gw - 1) + 3)
    else:
        bias_bytes = item * (bias_batch or 0) * h * n * nk
    nbytes = item * b * h * (2 * n + 2 * nk) * 64 + bias_bytes
    flops = 4.0 * b * h * n * nk * 64
    split = bound(nbytes, 3 * flops, "tf32") if dtype == "float32" else None
    return bound(nbytes, flops, dtype), split


def k1_fault_errors(q, k, v, bias, want):
    """What the K1 check sees of a faulty kernel: the max abs error against
    ``want`` of the answer a kernel with each fault would give, made by the
    plain version on the same inputs.  Faults: the last kv tile of 64 keys
    skipped (the ragged one where Nk % 64 != 0), the first one skipped, the
    output scaled by 0.8, each of which must exceed the case's bound; for
    f32, one TF32 pass (the plain version on q, k, v rounded to TF32),
    which must exceed K1_F32_ACCURACY."""
    import torch
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
    if q.dtype == torch.float32:
        r = fa.round_to_tf32
        faults["tf32_one_pass"] = lambda: fa.flash_attention_plain(
            r(q), r(k), r(v), bias)
    return {name: (f().float() - want.float()).abs().max().item()
            for name, f in faults.items()}


def k1_alpha_inputs(seed: int = 2):
    """The rescale check's (1, 16, K1_ALPHA_N, 64) bf16 q, k, v."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (1, 16, K1_ALPHA_N, 64)
    q = torch.randn(shape, generator=g) * 1.5
    q[..., 0] = 1.0
    k = torch.randn(shape, generator=g)
    k[..., 0] = 0.0
    k[:, :, 0] = 0.0
    k[:, :, 0, 0] = K1_ALPHA_KEY
    v = torch.linspace(-1.0, 1.0, K1_ALPHA_N)[:, None] + \
        0.1 * torch.randn(shape, generator=g)
    return [x.to("cuda", torch.bfloat16) for x in (q, k, v)]


def k1_online_softmax(q, k, v, alpha_form: str):
    """K1's bf16 body restated tile by tile (64 keys) in f32: exponents
    ex2(fma(x, log2e, nml)) with nml = -m.log2e rounded to f32, p rounded
    to bf16 before p.v, each fma rounded once (exact in f64 first), and
    alpha = ex2(fma(m_old, log2e, nml)) ("one_fma", the old form) or
    ex2((m_old - m_new).log2e) ("difference")."""
    import torch
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    log2e64 = log2e.double().item()
    log2e = log2e.item()

    def fma(a, c):
        return (a.double() * log2e64 + c.double()).float()
    qf = q.float()
    m = torch.full(q.shape[:3] + (1,), float("-inf"), device=q.device)
    ell = torch.zeros_like(m)
    o = torch.zeros(q.shape, device=q.device)
    for j in range(0, k.shape[2], 64):
        x = torch.matmul(qf, k[:, :, j:j + 64].float().transpose(-1, -2)) \
            * 0.125
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        nml = m_new * -log2e
        a = torch.exp2(fma(m, nml)) if alpha_form == "one_fma" else \
            torch.exp2((m - m_new) * log2e)
        alpha = torch.where(torch.isinf(m), torch.zeros_like(a), a)
        p = torch.exp2(fma(x, nml))
        ell = ell * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                     v[:, :, j:j + 64].float())
        m = m_new
    return (o / ell).to(torch.bfloat16)


def k1_alpha_drift(fa):
    """The rescale check on ``fa`` (a tree's ops.flash_attention): the
    signed mean error against f64 over all rows and its standard error,
    for the kernel, the plain version and both restated forms; and the
    kernel's max abs error against the plain version."""
    import torch
    q, k, v = k1_alpha_inputs()
    ref = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for h in range(q.shape[1]):   # one head at a time: 0.9 GB of scores
        s = torch.matmul(q[:, h].double(),
                         k[:, h].double().transpose(-1, -2)) * 0.125
        ref[:, h] = torch.matmul(torch.softmax(s, -1), v[:, h].double())
        del s
    got = fa.flash_attention_cuda(q, k, v)
    plain = fa.flash_attention_plain(q, k, v)
    out = {"max_abs_err": (got.float() - plain.float()).abs().max().item()}
    for name, ans in (("kernel", got), ("plain", plain),
                      ("one_fma", k1_online_softmax(q, k, v, "one_fma")),
                      ("difference", k1_online_softmax(q, k, v,
                                                       "difference"))):
        e = (ans.double() - ref).mean(-1).flatten()
        out[name] = (e.mean().item(), (e.std() / e.numel() ** 0.5).item())
    del q, k, v, ref, got, plain
    torch.cuda.empty_cache()
    return out


def phase_k1_alpha():
    """K1's rescale check (K1_ALPHA_*): the kernel's signed mean within
    K1_ALPHA_SIGMAS standard errors of 0, the old form's outside, and the
    kernel within the bf16 bound of the plain version."""
    from depthmap_tpu_torch.ops import flash_attention as fa
    d = k1_alpha_drift(fa)
    log("2-k1-alpha", n=K1_ALPHA_N, row_max_logit=K1_ALPHA_KEY / 8,
        max_abs_err=f"{d['max_abs_err']:.3e}",
        **{f"{name}_signed_mean": f"{d[name][0]:.3e}"
           for name in ("kernel", "plain", "one_fma", "difference")},
        **{f"{name}_stderr": f"{d[name][1]:.3e}"
           for name in ("kernel", "one_fma")}, sigmas=K1_ALPHA_SIGMAS)
    mean, se = d["kernel"]
    if not abs(mean) <= K1_ALPHA_SIGMAS * se:
        raise AssertionError(f"K1 bf16 drifts: signed mean {mean:.3e}, "
                             f"{abs(mean) / se:.1f} standard errors")
    old, old_se = d["one_fma"]
    if not abs(old) > K1_ALPHA_SIGMAS * old_se:
        raise AssertionError(f"the check would pass the old alpha: signed "
                             f"mean {old:.3e}, stderr {old_se:.3e}")
    if not d["max_abs_err"] <= K1_BOUND["bfloat16"]:
        raise AssertionError(f"K1 alpha case: max abs err "
                             f"{d['max_abs_err']}")
    return d


def sdpa_times(q, k, v, bias):
    """SDPA on the same tensors, the port's yardsticks (it never calls
    them): {backend: (ms, device ms) or "refused"}.  The efficient backend takes the
    padded-row mask and f32; the flash backend takes no mask and no f32;
    cuDNN's takes what its build accepts."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for lib, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                         ("flash", SDPBackend.FLASH_ATTENTION),
                         ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        def sdpa_call():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=bias)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the reasons it refuses
                sdpa_call()
        except RuntimeError:
            out[lib] = "refused"
            continue
        out[lib] = (cuda_ms(sdpa_call, 10), device_ms(sdpa_call, 5))
    return out


def k1_rel_case(name, dts, b, h, grid, g):
    """One table-mode row of phase 2: the kernel byte-equal to K1 with the
    bias materialized from the same table (``rel_pos_bias``, the inline
    tier's gather), and within the K1 bound of the plain streamed version
    (``attention_rel_streamed``) on the card, which the answers of two
    planted faults (gh and gw swapped, on a grid that is not square; the
    two cls entries swapped), made by the plain version, must break; the
    times of the kernel, the materialized-bias call, the plain version,
    SDPA's backends with the materialized bias, and the gather of that
    bias.  q ~ 4 N(0, 1), v ~ N(0, 1) / 4 as for every K1 case, the
    (T, H) table ~ K1_REL_TABLE_STD N(0, 1)."""
    import torch
    from depthmap_tpu_torch.models.attention import (RelBiasSpec,
                                                     attention_rel_streamed)
    from depthmap_tpu_torch.models.beit import rel_pos_bias
    from depthmap_tpu_torch.ops import flash_attention as fa
    dt = getattr(torch, dts)
    gh, gw = grid
    n = gh * gw + 1
    t_len = (2 * gh - 1) * (2 * gw - 1) + 3

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dt)
    q = mk(b, h, n, 64, scale=K1_Q_SCALE)
    k, v = mk(b, h, n, 64), mk(b, h, n, 64, scale=K1_V_SCALE)
    table = mk(t_len, h, scale=K1_REL_TABLE_STD)
    # the (H, T) table in the layout the tree's table mode reads (rows
    # padded to 16 bytes; a tree without pad_table_rows takes them
    # contiguous)
    pad = getattr(fa, "pad_table_rows", None)
    table_ht = pad(table) if pad else table.t().contiguous()

    def rel_call():
        return fa.flash_attention_rel(q, k, v, table_ht, grid)
    got = rel_call()
    torch.cuda.synchronize()
    bias = rel_pos_bias(table, grid, grid)
    materialized = fa.flash_attention_cuda(q, k, v, bias)
    equal = bool(torch.equal(got, materialized))
    del materialized

    def plain(tab=table, spec_grid=grid):
        return attention_rel_streamed(q, k, v, RelBiasSpec(tab, *spec_grid))
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    tol = K1_BOUND[dts]
    acc = K1_F32_ACCURACY if dts == "float32" else tol
    num_rel = t_len - 3
    cls_swapped = table.clone()
    cls_swapped[[num_rel, num_rel + 1]] = table[[num_rel + 1, num_rel]]
    faults = {"cls_swapped": lambda: plain(cls_swapped)}
    if gh != gw:
        faults["grid_swapped"] = lambda: plain(spec_grid=(gw, gh))
    faults = {f: (fn().float() - want.float()).abs().max().item()
              for f, fn in faults.items()}
    del want
    ms = cuda_ms(rel_call, 10)
    dev_ms = device_ms(rel_call, 5)
    mat_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, bias), 10)
    mat_dev_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, bias), 5)
    # the floor: the same body without a bias
    none_dev_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v), 5)
    plain_ms = cuda_ms(plain, 1)
    gather_ms = cuda_ms(lambda: rel_pos_bias(table, grid, grid), 3)
    library = sdpa_times(q, k, v, bias)
    (bound_ms, basis), split = k1_bound(b, h, n, n, ("rel", gh, gw), dts)
    (mat_bound_ms, mat_basis), _ = k1_bound(b, h, n, n, 1, dts)
    lib_kw = {}
    for lib in ("efficient", "cudnn"):
        t = library[lib]
        if t == "refused":
            lib_kw[f"sdpa_{lib}_materialized"] = t
        else:
            lib_kw[f"sdpa_{lib}_materialized_ms"] = f"{t[0]:.4f}"
            lib_kw[f"sdpa_{lib}_materialized_device_ms"] = \
                f"{t[1]:.4f}"
    split_kw = {} if split is None else dict(
        split_tf32_bound_us=f"{split[0] * 1e3:.1f}",
        device_share_of_split_tf32_bound=f"{split[0] / dev_ms:.3f}")
    log("2-k1-rel", case=name, grid=f"{gh}x{gw}",
        equal_to_materialized=equal, max_abs_err=f"{err:.3e}", tol=tol,
        **({"f32_accuracy": acc} if dts == "float32" else {}),
        ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
        materialized_ms=f"{mat_ms:.4f}",
        materialized_device_ms=f"{mat_dev_ms:.4f}",
        device_share_of_materialized=f"{dev_ms / mat_dev_ms:.3f}",
        bias_free_device_ms=f"{none_dev_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", gather_ms=f"{gather_ms:.4f}", **lib_kw,
        bound_us=f"{bound_ms * 1e3:.1f}", bound_by=basis,
        device_share_of_bound=f"{bound_ms / dev_ms:.3f}",
        materialized_bound_us=f"{mat_bound_ms * 1e3:.1f}",
        materialized_bound_by=mat_basis, **split_kw,
        **{f"fault_{f}_err": f"{e:.3e}" for f, e in faults.items()})
    if not equal:
        raise AssertionError(f"K1 {name}: table mode differs from K1 with "
                             "the materialized bias")
    if not err <= min(tol, acc):
        raise AssertionError(f"K1 {name}: max abs err {err} > "
                             f"{min(tol, acc)}")
    if not min(faults.values()) > tol:
        raise AssertionError(f"K1 {name}: a faulty kernel would pass the "
                             f"bound {tol}: {faults}")
    eff = library["efficient"]
    row = dict(case=name, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               library_ms=None if eff == "refused" else eff[0],
               materialized_ms=mat_ms, materialized_device_ms=mat_dev_ms,
               bias_free_device_ms=none_dev_ms, gather_ms=gather_ms, bound_ms=bound_ms, bound_by=basis,
               max_abs_err=err)
    del q, k, v, table, table_ht, bias, got
    torch.cuda.empty_cache()
    return err, row


def phase_k1():
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = 0.0
    main = f32_main = rel_main = None
    for name, dts, b, h, n, bb, *rest in K1_CASES:
        if isinstance(bb, tuple):
            err, row = k1_rel_case(name, dts, b, h, bb[1:], g)
            worst = max(worst, err)
            if name == K1_REL_MAIN:
                rel_main = row
            continue
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
        acc = K1_F32_ACCURACY if dts == "float32" else tol
        faults = k1_fault_errors(q, k, v, bias, want)
        del want
        torch.cuda.empty_cache()
        def k1_call():
            return fa.flash_attention_cuda(q, k, v, bias)
        ms = cuda_ms(k1_call, 10)
        dev_ms = device_ms(k1_call, 5)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                           3)
        library = sdpa_times(q, k, v, bias)
        (bound_ms, basis), split = k1_bound(b, h, n, nk, bb, dts)
        lib_kw = {}
        for lib, t in library.items():
            if t == "refused":
                lib_kw[f"sdpa_{lib}"] = t
            else:
                lib_kw[f"sdpa_{lib}_ms"] = f"{t[0]:.4f}"
                lib_kw[f"sdpa_{lib}_device_ms"] = \
                    f"{t[1]:.4f}"
        split_kw = {} if split is None else dict(
            split_tf32_bound_us=f"{split[0] * 1e3:.1f}",
            split_tf32_bound_by=split[1],
            device_share_of_split_tf32_bound=f"{split[0] / dev_ms:.3f}")
        log("2-k1", case=name, max_abs_err=f"{err:.3e}", tol=tol,
            **({"f32_accuracy": acc} if dts == "float32" else {}),
            ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", **lib_kw,
            bound_us=f"{bound_ms * 1e3:.1f}", bound_by=basis,
            share_of_bound=f"{bound_ms / ms:.3f}",
            device_share_of_bound=f"{bound_ms / dev_ms:.3f}", **split_kw,
            **{f"fault_{f}_err": f"{e:.3e}" for f, e in faults.items()})
        if not err <= min(tol, acc):
            raise AssertionError(f"K1 {name}: max abs err {err} > "
                                 f"{min(tol, acc)}")
        tf32 = faults.pop("tf32_one_pass", None)
        if not min(faults.values()) > tol:
            raise AssertionError(f"K1 {name}: a faulty kernel would pass "
                                 f"the bound {tol}: {faults}")
        if tf32 is not None and not tf32 > acc:
            raise AssertionError(f"K1 {name}: one TF32 pass ({tf32:.3e}) "
                                 f"would pass the f32 bound {acc}")
        worst = max(worst, err)
        eff = library["efficient"]
        row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=eff[0], library_device_ms=eff[1],
                   bound_ms=bound_ms, bound_by=basis)
        if main is None:
            main = row
        if name == K1_F32_MAIN:
            f32_main = dict(row, case=name, max_abs_err=err,
                            cuda_core_bound_ms=bound_ms,
                            bound_ms=split[0], bound_by=split[1])
        del q, k, v, bias, got
        torch.cuda.empty_cache()
    return worst, main, f32_main, rel_main


def k2_stages(img, nd, div, sharp):
    """K2's two stages timed apart, the sweep's steps and its replay
    counters on one call: (sort_ms, sweep_ms, max steps of a row, mean
    steps, counters)."""
    import torch
    from depthmap_tpu_torch.ops import polylines as pl
    rows, w, ch = img.shape
    sorted_, rgb, order = pl._sort_cuda(img, nd, div, 0.0, 1.0, sharp)
    pl.reset_replay_counts()
    pl._sweep_cuda(sorted_, rgb, order, w, ch, sharp)
    counts = pl.replay_counts()
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
    return sort_ms, sweep_ms, int(steps.max()), float(steps.mean()), counts


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
    # (at 1080p each sharp / soft fill at one sign and magnitude of each;
    # the other four variants run in tests/test_torch_port_cuda.py at
    # smaller shapes, which keeps the smoke inside its time)
    cases = [(1080, "random", True, 24.0), (1080, "random", True, -48.0),
             (1080, "random", False, -24.0), (1080, "random", False, 48.0)] + \
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
            sort_ms, sweep_ms, steps, mean, counts = k2_stages(img, m, div,
                                                               sharp)
            extra = dict(sort_ms=f"{sort_ms:.4f}", sweep_ms=f"{sweep_ms:.4f}",
                         steps_max=steps, steps_mean=f"{mean:.1f}",
                         sweep_ns_per_step=f"{sweep_ms * 1e6 / steps:.1f}",
                         share_of_bound=f"{bounds[rows][0] / ms:.5f}",
                         parts=counts["parts"],
                         parts_replayed=counts["parts_replayed"],
                         rows_whole=counts["rows_whole"])
        log("3-k2", shape=f"{rows}x{img.shape[1]}", depth=depth, sharp=sharp,
            divergence_px=div, bytes_differ=ndiff, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.1f}", **extra)
        if ndiff:
            raise AssertionError(f"K2 {rows} {depth} sharp={sharp} div={div}:"
                                 f" {ndiff} bytes differ from the plain "
                                 "version")
        if rows == 1080 and depth == "random" and sharp and abs(div) == 24.0:
            timed.append((ms, plain_ms))
            if div > 0:   # phase 18's split is held to this eye
                _KEEP["k2_eye"] = (img, m, div, got)
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
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    for label, imgs in paths:
        profile_call(label, lambda: list(core_generation_funnel(
            None, imgs, None, None, inp, ops, predictor_cache=cache)))


def _launch_counts() -> dict:
    """K1's launches (the sum over its modes) and K2's two stages', as the
    wrappers count them."""
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    return {"k1": sum(fa.flash_attention_cuda.launches_by_mode.values()),
            "k2_sort": pl._sort_cuda.launches,
            "k2_sweep": pl._sweep_cuda.launches}


def _profiled_kernel(key: str):
    """The ``_launch_counts`` key of a profiler's kernel name, or None."""
    if K1_KERNEL in key:
        return "k1"
    if "polylines_sort" in key:
        return "k2_sort"
    if "polylines_sweep" in key:
        return "k2_sweep"
    return None


def profile_call(label, fn):
    """torch.profiler over one call of ``fn``: its wall ms, device ms by
    kernel, the busy share, and K1's and K2's share of the device time.
    The launches of K1 and of K2's two stages the profile saw must equal
    the wrappers' counts over the call.  Where the profile lost one, a
    full ``--profile`` run profiles the phase again in a fresh process at
    its end (``--phase``), and anywhere else it fails; no sum of such a
    profile is printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = _launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = _launch_counts()
    ran = {key: after[key] - before[key] for key in after}
    dev, seen = {}, dict.fromkeys(ran, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        dev[e.key] = dev.get(e.key, 0.0) + t / 1e3
        kernel = _profiled_kernel(e.key)
        if kernel:
            seen[kernel] += e.count
    if seen != ran:
        log("profile-lost-launches", path=label, seen=seen, launched=ran)
        if _PROFILE["again"] is None:
            raise AssertionError(f"profile of {label}: the profiler saw "
                                 f"{seen} of the launches {ran}")
        _PROFILE["again"].add(_PROFILE["phase"])
        return
    total = sum(dev.values())
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    k1 = sum(t for k, t in dev.items() if K1_KERNEL in k)
    k2_sort = sum(t for k, t in dev.items() if "polylines_sort" in k)
    k2_sweep = sum(t for k, t in dev.items() if "polylines_sweep" in k)
    k2 = k2_sort + k2_sweep
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    log("profile", path=label, wall_ms=f"{wall_ms:.2f}",
        device_ms=f"{total:.2f}", busy=f"{total / wall_ms:.3f}",
        launches_checked=ran,
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
        fa.reset_launches()
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
    the host: one forward), written to a temporary directory
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
        fa.reset_launches()
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
    """dpt_beit_large_512 with polylines_sharp stereo: the funnel's chunk
    of the 4 x 512^2 images and its chunk of one 1080p image (inline
    per-block bias, table resize), a forward each."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(compute_device="GPU",
                            model_type="dpt_beit_large_512",
                            net_width=512, net_height=512, gen_stereo=True,
                            stereo_modes=["left-right", "red-cyan-anaglyph"],
                            stereo_fill_algo="polylines_sharp")
    return drive_funnel("4-main", inp, images,
                        [("512_chunk", 4), ("1080p_chunk", 1)],
                        forwards=2, k2_eyes=2 * len(images), profile=profile)


def phase_default_options(profile: bool = False):
    """GenerationOptions() defaults (Depth Anything v2 Base, net 448^2)
    with naive-fill stereo: a chunk of 4 x 512^2 (N = 1025), one 1080p
    image (N = 1825)."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(6, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(gen_stereo=True, stereo_fill_algo="naive")
    return drive_funnel("6-default", inp, images,
                        [("512_chunk", 4), ("1080p_chunk", 1)],
                        forwards=2, k2_eyes=0, profile=profile)


def phase_long_n(profile: bool = False):
    """Depth Anything v2 Large with net_size_match on one 1080p image,
    depth only: net 1932 x 1092, a 78 x 138 grid, N = 10765."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(7, [(1080, 1920)])
    inp = GenerationOptions(model_type="Depth Anything v2 Large",
                            net_size_match=True)
    return drive_funnel("7-long-n", inp, images, [("1080p_chunk", 1)],
                        forwards=1, k2_eyes=0, profile=profile, runs=2)


def phase_dpt_large(profile: bool = False):
    """This slice's path: dpt_large_384 with depth, normal map and
    heatmap on the images of phase 4 at net 384: a chunk of 4 x 512^2 (N
    = 577), one 1080p image (672 x 384, N = 1009); then the simple
    mesh of one 512^2 image."""
    from depthmap_tpu_torch.options import GenerationOptions
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    inp = GenerationOptions(compute_device="GPU", model_type="dpt_large_384",
                            net_width=384, net_height=384,
                            gen_normalmap=True, gen_heatmap=True)
    k1, _ = drive_funnel("9-dpt-large", inp, images,
                         [("512_chunk", 4), ("1080p_chunk", 1)],
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
            [("512_chunk", 4), ("1080p_chunk", 1)], forwards=2,
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
            [("512_chunk", 4), ("1080p_chunk", 1)], forwards=2,
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
    chunk of patches), never for LeReS; a BEiT model's forwards whose
    block bias is over the stream budget run K1's table mode, and there
    must be some.  Returns the timed runs' K1 launches, those in table
    mode, and the last image's R_x."""
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
    launches = rel = 0
    for image in images:
        h, w = image.shape[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        out = list(core_generation_funnel(None, [image], None, None, inp,
                                          ops, cache))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1 = fa.flash_attention_cuda.launches
        by_mode = dict(fa.flash_attention_cuda.launches_by_mode)
        engine = cache._boost
        run = engine.last_run
        blocks = backbone_shape(engine.predictor.bundle.module)[0]
        want = blocks * (2 + 2 * run["chunks"])
        d = out[0][2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(phase, model=name, size=f"{h}x{w}", rf=engine.rf,
            R_x=run["whole_size"], patches=run["patches"],
            chunks=run["chunks"], s_per_image=f"{seconds:.3f}",
            k1_launches=k1, k1_expected=want, k1_by_mode=by_mode,
            max_memory_allocated_GiB=f"{peak:.3f}",
            dtype=str(engine.predictor.compute_dtype))
        if [t for _, t, _ in out] != ["depth"] or d.dtype != np.uint16 or \
                d.shape != (h, w) or int(d.max()) - int(d.min()) <= 0:
            raise AssertionError(f"{phase} {name}: outputs {out}")
        if k1 != want or (blocks > 0) != (by_mode["rel"] > 0):
            raise AssertionError(f"{phase} {name}: K1 launched {k1} times "
                                 f"({by_mode}), expected {want}, table "
                                 "mode on BEiT only")
        launches += k1
        rel += by_mode["rel"]
        if profile:
            profile_paths(cache, inp, [(f"{phase}_{name}_{h}x{w}", [image])],
                          ops)
    cache.release()
    torch.cuda.empty_cache()
    return launches, rel, run["whole_size"]


def phase_boost(profile: bool = False):
    """Boost at r_max 1600 on res101 (1080p and 4:3) and on
    dpt_beit_large_512 (a textured 4:3 image: R_x 1536, N = 6913), every
    K1 shape held by phase 2; then the device chain and pix2pix, card
    against CPU."""
    os.environ["DEPTHMAP_ALLOW_RANDOM_PIX2PIX"] = "1"
    with k1_shapes() as shapes:
        drive_boost("13-boost", "res101",
                    [_test_images(13, [(1080, 1920)])[0],
                     _test_images(14, [(768, 1024)])[0]], profile)
        k1, rel, whole = drive_boost("13-boost", "dpt_beit_large_512",
                                     [_textured(15, 768, 1024)], profile)
    check_k1_shapes("13", shapes.seen)
    if whole != 1536:
        raise AssertionError(f"BEiT's Boost ran its whole image at R_x "
                             f"{whole}, not 1536")
    phase_boost_numerics()
    return k1, rel


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
    with the K1 counts set to 0 just before it: 32 launches a UNet forward,
    384 an image, all in K1's f32 body."""
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
    fa.reset_launches()
    t0 = time.perf_counter()
    out = list(core_generation_funnel(None, [image], None, None, inp, ops,
                                      cache))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = fa.flash_attention_cuda.launches
    k1_f32 = fa.flash_attention_cuda.launches_by_dtype["float32"]
    hook.remove()
    d = out[0][2]
    log(phase, size=f"{h}x{w}", res=768, ensemble=5, steps=12,
        dtype=str(pred.compute_dtype), attention_dtype=sorted(attn_dtypes),
        s_warm=f"{warm_s:.3f}", s_per_image=f"{seconds:.3f}",
        k1_launches=k1, k1_f32_launches=k1_f32,
        max_memory_allocated_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if d.dtype != np.uint16 or d.shape != (h, w) or \
            int(d.max()) - int(d.min()) <= 0:
        raise AssertionError(f"{phase}: depth {d.dtype} {d.shape}")
    if attn_dtypes != {"torch.float32"}:
        raise AssertionError(f"{phase}: the UNet's attention ran in "
                             f"{attn_dtypes}, not in f32 as the JAX "
                             "package's promotion runs it")
    if k1 != 32 * 12 or k1_f32 != k1:
        raise AssertionError(f"{phase}: K1 launched {k1} times, {k1_f32} "
                             "in its f32 body; expected 384 (32 a UNet "
                             "forward, 12 steps), all f32")
    if profile:
        profile_paths(cache, inp, [(f"{phase}_{pred.compute_dtype}",
                                    [image])], ops)
    cache.release()
    del pred, cache, Cache, bundle
    gc.collect()    # the class above sits in a cycle (super's cell)
    torch.cuda.empty_cache()
    return k1, k1_f32


def phase_marigold(profile: bool = False):
    """Marigold v1 at full width (random weights from a seed) on a 4:3
    image, f32 then bf16; then card against CPU at processing_res 64."""
    import torch
    from depthmap_tpu_torch.models.marigold.pipeline import build_marigold
    from depthmap_tpu_torch.models.weights import init_random_
    t0 = time.perf_counter()
    sd = init_random_(build_marigold(), seed=4).state_dict()
    _KEEP["marigold_sd"] = sd      # phase 18's split runs these weights
    log("14-marigold", weights=len(sd),
        params_M=f"{sum(t.numel() for t in sd.values()) / 1e6:.1f}",
        init_s=f"{time.perf_counter() - t0:.2f}")
    image = _test_images(17, [(768, 1024)])[0]
    launches, launches_f32 = {}, {}
    for dtype in ("float32", "bfloat16"):
        os.environ["DEPTHMAP_MARIGOLD_DTYPE"] = dtype
        launches[dtype], launches_f32[dtype] = drive_marigold(
            "14-marigold", image, sd, profile)
    os.environ.pop("DEPTHMAP_MARIGOLD_DTYPE")
    phase_marigold_numerics(sd)
    return launches, launches_f32


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


# K1 launches of video mode's pass 1 (20 frames in chunks of 8: 3 forwards
# of DA v2 Base's 12 blocks) and of the 3D photo's one forward
VIDEO_FRAMES, VIDEO_CHUNK = 20, 8
VIDEO_K1 = 3 * 12
PHOTO_K1 = 12
# the 3D photo's demo trajectories at 30 frames each (the funnel's demos
# run 300: cut to keep the smoke inside its time)
DEMO_FRAMES_SMOKE = 30
# the inpainting nets, card (TF32 off) against CPU, f32: a share of the
# CPU output's range
NET_RTOL = 1e-4


class _Timed:
    """Wrap ``module.name`` (a function) to add its wall seconds (after a
    card sync) to ``self.seconds`` and keep its last result; ``restore``
    puts the original back."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds, self.calls, self.last = 0.0, 0, None

        def wrapped(*args, **kw):
            import torch
            t0 = time.perf_counter()
            out = self.orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.last = out
            return out
        setattr(module, name, wrapped)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def _counts():
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    return (fa.flash_attention_cuda.launches, pl._sort_cuda.launches,
            pl._sweep_cuda.launches)


def _zero_counts():
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    fa.reset_launches()
    pl._sort_cuda.launches = 0
    pl._sweep_cuda.launches = 0


def _save_pngs(images, directory):
    from PIL import Image
    os.makedirs(directory, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:   # zlib releases the GIL
        list(pool.map(lambda ia: Image.fromarray(ia[1]).save(
            os.path.join(directory, f"frame{ia[0]:04d}.png")),
            enumerate(images)))


def phase_video(profile: bool = False):
    """Video mode through gen_video: GenerationOptions() (DA v2 Base, net
    448) with polylines_sharp stereo on 20 textured 1920 x 1080 PNG frames:
    pass 1 in chunks of 8 (the tail of 4 its own batch), 36 K1 launches;
    pass 2 injects the maps, no K1, K2's sort and sweep once per eye (40
    each).  Then pass 1's maps (uint8 chunks) against predict_batch on the
    f32 /255 stacks, chunk by chunk, on the card."""
    import tempfile
    import numpy as np
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline import video_mode as vm
    from depthmap_tpu_torch.pipeline.core import PredictorCache
    images = _test_images(19, [(1080, 1920)] * VIDEO_FRAMES)
    inp = GenerationOptions(gen_stereo=True)
    cache = PredictorCache()
    pred = cache.get(inp.model_type, device=torch.device("cuda"))
    stacks = [np.stack(images[s:s + VIDEO_CHUNK]).astype(np.float32) / 255.0
              for s in range(0, VIDEO_FRAMES, VIDEO_CHUNK)]
    for s in stacks[-2:]:          # warm-up: cuDNN, the grid's inputs
        pred.predict_batch(s, 448, 448)
    with tempfile.TemporaryDirectory() as tmp:
        _save_pngs(images, os.path.join(tmp, "frames"))
        pass1 = _Timed(vm, "_predict_video_depths")
        writes = _Timed(vm, "frames_to_video")
        pass1_counts, pass1_maps = [], []
        orig = pass1.orig

        def pass1_then_count(*args, **kw):
            out = orig(*args, **kw)
            pass1_counts.append(_counts())
            pass1_maps.append(out)
            return out
        pass1.orig = pass1_then_count
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            written = vm.gen_video(os.path.join(tmp, "frames"),
                                   os.path.join(tmp, "out"), inp,
                                   predictor_cache=cache)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            k1, sorts, sweeps = _counts()
        finally:
            pass1.restore()
            writes.restore()
        peak = torch.cuda.max_memory_allocated() / 2**30
        sizes = {os.path.basename(p): os.path.getsize(p) for p in written}
        from depthmap_tpu_torch.io.avi import read_gray16_avi
        fps, depth = read_gray16_avi([p for p in written
                                      if p.endswith(".avi")][0])
    k1_p1, sorts_p1, sweeps_p1 = pass1_counts[0]
    pass2_s = total - pass1.seconds - writes.seconds
    log("15-video", model=pred.spec.name, frames=VIDEO_FRAMES,
        size="1080x1920", chunk=VIDEO_CHUNK,
        k1_shapes=[(len(s), 12, attention_tokens(pred, inp, images[0]))
                   for s in stacks],
        k2_eye="1080x1920", fill=inp.stereo_fill_algo,
        pass1_s=f"{pass1.seconds:.3f}",
        pass1_frames_per_s=f"{VIDEO_FRAMES / pass1.seconds:.2f}",
        pass2_s_per_frame=f"{pass2_s / VIDEO_FRAMES:.4f}",
        writes_s=f"{writes.seconds:.3f}", s_total=f"{total:.3f}",
        k1_pass1=k1_p1, k1_pass2=k1 - k1_p1, k2_sorts_pass2=sorts - sorts_p1,
        k2_sweeps_pass2=sweeps - sweeps_p1, written=sizes,
        max_memory_allocated_GiB=f"{peak:.3f}")
    if sorted(sizes) != ["depthmap-0-depth_video.avi",
                         "depthmap-0-left-right_video.gif",
                         "depthmap-0-red-cyan-anaglyph_video.gif"]:
        raise AssertionError(f"video mode wrote {sorted(sizes)}")
    if len(depth) != VIDEO_FRAMES or depth[0].shape != (1080, 1920) or \
            int(depth[0].max()) - int(depth[0].min()) <= 0:
        raise AssertionError("video mode's depth video is not 20 live "
                             "1080p frames")
    if (k1_p1, k1 - k1_p1) != (VIDEO_K1, 0):
        raise AssertionError(f"video: K1 launched {k1_p1} times in pass 1 "
                             f"and {k1 - k1_p1} in pass 2, expected "
                             f"{VIDEO_K1} and 0")
    if (sorts_p1, sweeps_p1) != (0, 0) or \
            (sorts, sweeps) != (2 * VIDEO_FRAMES, 2 * VIDEO_FRAMES):
        raise AssertionError(f"video: K2 sorts {sorts} / sweeps {sweeps} "
                             f"(pass 1: {sorts_p1} / {sweeps_p1}), expected "
                             f"{2 * VIDEO_FRAMES} each in pass 2")
    # pass 1 against predict_batch on the f32 stacks, chunk by chunk
    before = fa.flash_attention_cuda.launches
    sign = -1.0 if pred.raw_prediction_invert else 1.0
    for i, s in enumerate(stacks):
        got = np.stack(pass1_maps[0][i * VIDEO_CHUNK:(i + 1) * VIDEO_CHUNK])
        want = sign * pred.predict_batch(s, 448, 448)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"video pass 1's chunk {i} differs from "
                                 "predict_batch on the card: max "
                                 f"{np.abs(got - want).max()}")
    log("15-video-pass1", chunks=[len(s) for s in stacks], equal=True,
        k1_launches=fa.flash_attention_cuda.launches - before)
    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            _save_pngs(images, os.path.join(tmp, "frames"))
            profile_call("15_video", lambda: vm.gen_video(
                os.path.join(tmp, "frames"), os.path.join(tmp, "out"), inp,
                predictor_cache=cache))
    cache.release()
    del pred
    torch.cuda.empty_cache()
    return k1_p1, sweeps


def _crop_planes(image, seed):
    """One 256 x 256 crop of the image with a context and a hole mask
    and a disparity and an edge plane, as build_ldi hands them to the
    nets."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rgb01 = image[100:356, 200:456].astype(np.float32) / 255.0
    ctx = (rng.random((256, 256)) > 0.4).astype(np.float32)
    mask = (1 - ctx) * (rng.random((256, 256)) > 0.3).astype(np.float32)
    disp = (0.3 + rng.random((256, 256))).astype(np.float32)
    edge = (rng.random((256, 256)) > 0.9).astype(np.float32)
    return rgb01, disp, edge, ctx, mask


def phase_3dphoto(profile: bool = False):
    """The 3D photo through core_generation_funnel (GenerationOptions(),
    gen_inpainted_mesh) on one textured 768 x 1024 image, from a working
    directory whose models/3dphoto holds seeded full-width checkpoints in
    the reference layout: 12 K1 launches, the nets on the card, an OBJ of
    at least H x W vertices; the funnel's demo trajectories at 30 frames
    (run_3dphoto_videos) and one run_makevideo at vid_ssaa 3 over 4
    frames; then card against CPU: the weighted median, each net on one
    bucketed crop, one rendered frame."""
    import tempfile
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.weights import \
        save_random_inpaint_checkpoints
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline import inpaint_mesh as im
    from depthmap_tpu_torch.pipeline import inpaint_video as iv
    from depthmap_tpu_torch.pipeline import render
    from depthmap_tpu_torch.pipeline.core import (PredictorCache,
                                                  core_generation_funnel)
    image = _textured(20, 768, 1024)
    h, w = image.shape[:2]
    inp = GenerationOptions(gen_inpainted_mesh=True)
    cache = PredictorCache()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "models", "3dphoto")
        save_random_inpaint_checkpoints(ckpt, seed=16)
        os.chdir(tmp)
        net_calls = im.net_calls
        stages = {n: _Timed(m, n) for m, n in (
            (iv, "sparse_bilateral_filtering"), (im, "build_ldi"),
            (im, "edge_pixel_groups"), (im, "run_net"),
            (im, "write_mesh_file"))}
        try:
            # warm-up: the model and its forward at this size
            cache.get(inp.model_type, device=torch.device("cuda")) \
                .predict_finalized(image.astype(np.float32) / 255.0, 448, 448)
            calls_before = dict(net_calls)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            out = list(core_generation_funnel(os.path.join(tmp, "out"),
                                              [image], None, ["photo"], inp,
                                              predictor_cache=cache))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            k1 = _counts()[0]
        finally:
            for t in stages.values():
                t.restore()
            os.chdir(cwd)
        peak = torch.cuda.max_memory_allocated() / 2**30
        calls = {k: v - calls_before.get(k, 0) for k, v in net_calls.items()
                 if v != calls_before.get(k, 0)}
        types = [t for _, t, _ in out]
        mesh = out[-1][2]
        with open(mesh) as f:
            head = [next(f) for _ in range(9)]
        n_verts = int(head[6].split()[-1])
        n_faces = int(head[7].split()[-1])
        verts, colors, faces = stages["build_ldi"].last[:3]
        groups = stages["edge_pixel_groups"].last[1]
        nets_s = stages["run_net"].seconds
        filter_s = stages["sparse_bilateral_filtering"].seconds
        log("16-3dphoto", model=cache._predictor.spec.name,
            size=f"{h}x{w}",
            k1_shape=(1, 12, attention_tokens(cache._predictor, inp, image)),
            s_total=f"{seconds:.3f}", k1_launches=k1,
            filter_ms=f"{filter_s * 1e3:.1f}",
            ldi_host_ms=f"{(stages['build_ldi'].seconds - nets_s) * 1e3:.1f}",
            edge_groups=groups, net_calls=calls, nets_ms=f"{nets_s * 1e3:.1f}",
            vertices=n_verts, faces=n_faces,
            write_ms=f"{stages['write_mesh_file'].seconds * 1e3:.1f}",
            obj_MB=f"{os.path.getsize(mesh) / 1e6:.1f}",
            max_memory_allocated_GiB=f"{peak:.3f}")
        if types != ["depth", "inpainted_mesh"]:
            raise AssertionError(f"3D photo: outputs {types}")
        if k1 != PHOTO_K1:
            raise AssertionError(f"3D photo: K1 launched {k1} times, "
                                 f"expected {PHOTO_K1}")
        if not calls or set(dev for _, dev in calls) != {"cuda"} or \
                len(set(calls.values())) != 1:
            raise AssertionError(f"3D photo: the nets ran {calls}")
        if n_verts < h * w or n_verts != len(verts) or n_faces == 0:
            raise AssertionError(f"3D photo: {n_verts} vertices, "
                                 f"{n_faces} faces, expected >= {h * w}")
        depth16 = out[0][2]

        # the demo trajectories, 30 frames each
        ks, footprint = [], _Timed(render.MeshRenderer, "_measure_footprint")
        renders = _Timed(render.MeshRenderer, "render")
        orig = footprint.orig

        def measure(self, *a):
            k = orig(self, *a)
            ks.append(k)
            return k
        footprint.orig = measure
        try:
            t0 = time.perf_counter()
            videos = iv.run_3dphoto_videos(
                mesh, "photo", os.path.join(tmp, "demos"),
                DEMO_FRAMES_SMOKE, iv.DEMO_FPS, vid_dolly=False,
                vid_format="mp4", vid_ssaa=1, **iv.DEMO_TRAJECTORIES)
            demo_s = time.perf_counter() - t0
            n_demo = renders.calls
            render_s, foot_s = renders.seconds, footprint.seconds
            t0 = time.perf_counter()
            made = iv.run_makevideo(mesh, 4, 40, 1, "0.02,0.01,-0.05",
                                    "0.03,0.03,0.05,0.03", False, "mp4", 3,
                                    outpath=os.path.join(tmp, "made"))
            make_s = time.perf_counter() - t0
        finally:
            footprint.restore()
            renders.restore()
        log("16-3dphoto-videos", trajectories=4, frames=DEMO_FRAMES_SMOKE,
            renders=n_demo, demo_s=f"{demo_s:.3f}",
            render_ms_per_frame=f"{render_s * 1e3 / n_demo:.2f}",
            footprint_ms_per_frame=f"{foot_s * 1e3 / n_demo:.2f}",
            K=sorted(set(ks)),
            written={os.path.basename(p): os.path.getsize(p)
                     for p in videos},
            makevideo_ssaa3_s=f"{make_s:.3f}",
            makevideo=os.path.basename(made[0]))
        if len(videos) != 4 or n_demo != 4 * DEMO_FRAMES_SMOKE:
            raise AssertionError(f"3D photo demos: {videos}, {n_demo} "
                                 "renders")
        mesh_data = iv._video_mesh["data"]     # read by the videos above
        if profile:
            os.chdir(tmp)
            try:
                profile_call("16_3dphoto", lambda: list(
                    core_generation_funnel(os.path.join(tmp, "prof"),
                                           [image], None, None, inp,
                                           predictor_cache=cache)))
            finally:
                os.chdir(cwd)
            profile_call("16_3dphoto_demo_render", lambda: iv.output_3d_photo(
                *mesh_data[:7], [[np.eye(4)] * 4], [""],
                os.path.join(tmp, "prof_render"), "r", {"fps": 40},
                mesh_data[7]))
        photo_numerics(image, depth16, ckpt, mesh_data)
    cache.release()
    torch.cuda.empty_cache()
    return k1


def photo_numerics(image, depth16, ckpt, mesh):
    """Card against CPU: the weighted median (window 7) on the phase's
    depth, equal; each net on one 256 x 256 crop (bucket 256), f32 with
    TF32 off, within NET_RTOL of the CPU output's range; one frame of the
    phase's mesh rendered at a 512 canvas: equal on >= 99.9% of the pixels
    and |d| <= 2 elsewhere."""
    import numpy as np
    import torch
    from depthmap_tpu_torch.pipeline import inpaint_mesh as im
    from depthmap_tpu_torch.pipeline import inpaint_video as iv
    from depthmap_tpu_torch.pipeline.render import MeshRenderer
    depth = iv.disparity_to_depth(depth16)
    disc = im.vis_depth_discontinuity(depth, 0.04)
    med, ms = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        med[dev] = im.weighted_median_filter(
            torch.from_numpy(depth).to(dev), torch.from_numpy(disc).to(dev),
            7).cpu().numpy()
        ms[f"median_{dev}"] = (time.perf_counter() - t0) * 1e3
    median_diff = int((med["cuda"] != med["cpu"]).sum())
    planes = _crop_planes(image, 21)
    errs = {}
    nets = {dev: im.build_inpaint_callables(ckpt, device=dev)
            for dev in ("cuda", "cpu")}
    depth_crop = depth[100:356, 200:456].astype(np.float32)
    args = {"edge": planes,
            "depth": (depth_crop, planes[2], planes[3], planes[4]),
            "color": (planes[0], planes[2], planes[3], planes[4])}
    for name, a in args.items():
        got = nets["cuda"][name](*a)
        want = nets["cpu"][name](*a)
        span = float(np.ptp(want))
        errs[name] = (float(np.abs(got - want).max()), span)
    verts, colors, faces, H, W, hfov, vfov, _ = mesh
    frames = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        frames[dev] = MeshRenderer(verts, colors, faces, max(hfov, vfov),
                                   512, device=dev).render(
                                       np.array([0.01, -0.01, -0.02]))
        ms[f"render_512_{dev}"] = (time.perf_counter() - t0) * 1e3
    d = np.abs(frames["cuda"].astype(int) - frames["cpu"])
    off = float(d.any(-1).mean())
    log("16-3dphoto-numerics", median_pixels_differ=median_diff,
        **{f"{k}_max_abs_err": f"{e:.3e}" for k, (e, _) in errs.items()},
        **{f"{k}_range": f"{s:.4f}" for k, (_, s) in errs.items()},
        net_tol=f"{NET_RTOL} x range", frame_pixels_differ=f"{off:.5f}",
        frame_max_diff=int(d.max()),
        **{k: f"{v:.1f}" for k, v in ms.items()})
    if median_diff:
        raise AssertionError(f"weighted median: {median_diff} pixels differ "
                             "between the card and the CPU")
    bad = {k: v for k, v in errs.items()
           if not (v[1] > 0 and v[0] <= NET_RTOL * v[1])}
    if bad:
        raise AssertionError(f"inpainting nets card vs CPU: {bad}")
    if off > 1e-3 or d.max() > 2:
        raise AssertionError(f"rendered frame card vs CPU: {off} of the "
                             f"pixels differ, up to {d.max()}")


# phase 17: the REST server.  Its one-process requests, then the same
# request through `python -m depthmap_tpu_torch.cli --serve` (a new process
# that reaches the card and builds its model: up to REST_SERVE_WAIT_S)
REST_SERVE_WAIT_S = 180
REST_VIDEO_FRAMES = 4


def _png_b64(arr):
    import base64
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _png_arrays(images_b64):
    import base64
    import io
    import numpy as np
    from PIL import Image
    return [np.asarray(Image.open(io.BytesIO(base64.b64decode(b))))
            for b in images_b64]


def _http(url, payload=None, data=None, headers=None, timeout=600):
    """(status, JSON body) of a GET (no payload / data) or a POST."""
    import urllib.error
    import urllib.request
    if payload is not None:
        data = json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _direct_images(images_b64, options):
    """The image outputs of a direct core_generation_funnel call on the
    request's decoded images and options (the default cache, as the
    server's)."""
    from depthmap_tpu_torch.frontends.api import (decode_base64_to_image,
                                                  is_image_output)
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    return [res for _, _, res in core_generation_funnel(
        None, [decode_base64_to_image(b) for b in images_b64], None, None,
        options) if is_image_output(res)]


def rest_generate(base, label, payload, k1_expected, k2_expected):
    """One POST /depth/generate against a direct funnel call: every PNG
    byte-equal to the direct output, the same K1 / K2 launches (K1 those
    of ``k1_expected``, K2's sort and sweep ``k2_expected`` each); a warm
    direct call first (model build, cuDNN's choices).  Returns (the
    decoded arrays, K1 launches, K2 sweeps)."""
    import numpy as np
    import torch
    options = payload["options"]
    _direct_images(payload["depth_input_images"], options)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    status, body = _http(base + "/depth/generate", payload)
    seconds = time.perf_counter() - t0
    request_counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if status != 200 or body.get("info") != "Success":
        raise AssertionError(f"17 {label}: {status} {str(body)[:300]}")
    got = _png_arrays(body["images"])
    _zero_counts()
    want = _direct_images(payload["depth_input_images"], options)
    direct_counts = _counts()
    if len(got) != len(want) or any(
            g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g, w) for g, w in zip(got, want)):
        raise AssertionError(f"17 {label}: the REST PNGs differ from the "
                             "direct funnel call")
    if request_counts != direct_counts or request_counts != (
            k1_expected, k2_expected, k2_expected):
        raise AssertionError(f"17 {label}: launches (K1, K2 sort, sweep) "
                             f"{request_counts} on the request, "
                             f"{direct_counts} direct, expected "
                             f"{(k1_expected, k2_expected, k2_expected)}")
    log("17-rest", request=label, images=len(payload["depth_input_images"]),
        pngs=len(got), s_per_request=f"{seconds:.4f}",
        k1_launches=request_counts[0], k2_sort_launches=request_counts[1],
        k2_launches=request_counts[2],
        max_memory_allocated_GiB=f"{peak:.3f}", byte_equal=True)
    return got, request_counts[0], request_counts[2]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rest_subprocess(payload, want):
    """The request through `python -m depthmap_tpu_torch.cli --serve` in a
    process of its own: its PNGs must equal ``want``; the process is
    stopped in every case."""
    import numpy as np
    import urllib.request
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "depthmap_tpu_torch.cli", "--serve",
         "--port", str(port)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        while True:
            try:
                with urllib.request.urlopen(base + "/depth/version",
                                            timeout=5):
                    break
            except OSError:
                if proc.poll() is not None or \
                        time.perf_counter() - t0 > REST_SERVE_WAIT_S:
                    raise AssertionError("17 --serve did not answer: "
                                         f"{proc.poll()}")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        status, body = _http(base + "/depth/generate", payload)
        seconds = time.perf_counter() - t1
        if status != 200:
            raise AssertionError(f"17 --serve: {status} {str(body)[:300]}")
        got = _png_arrays(body["images"])
        if len(got) != len(want) or not all(
                np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("17 --serve: its PNGs differ from the "
                                 "in-process server's")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    log("17-serve", command="python -m depthmap_tpu_torch.cli --serve",
        s_to_answer=f"{up_s:.1f}", s_first_request=f"{seconds:.3f}",
        pngs=len(got), byte_equal=True)


def rest_host_kernel():
    """The host polylines kernel against K2 on one 1080p sharp eye (+24
    px), byte for byte, and against polylines_plain on 270 x 480 (+6 px);
    each kernel's ms."""
    import torch
    from depthmap_tpu_torch.ops import polylines as pl
    g = torch.Generator(device="cpu").manual_seed(17)
    img, nds = k2_inputs(g, 1080, 1920)
    nd = nds["random"]
    img_h, nd_h = img.cpu(), nd.cpu()
    k2_out = pl.polylines_cuda(img, nd, 24.0, 0.0, 1.0, True)
    host = pl.polylines_host(img_h, nd_h, 24.0, 0.0, 1.0, True)
    differ = int((host != k2_out.cpu()).sum())
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pl.polylines_host(img_h, nd_h, 24.0, 0.0, 1.0, True)
        times.append((time.perf_counter() - t0) * 1e3)
    k2_ms = cuda_ms(lambda: pl.polylines_cuda(img, nd, 24.0, 0.0, 1.0, True),
                    10)
    small_img, small_nd = img_h[:270, :480].contiguous(), \
        nd_h[:270, :480].contiguous()
    t0 = time.perf_counter()
    plain = pl.polylines_plain(small_img, small_nd, 6.0, 0.0, 1.0, True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    small = pl.polylines_host(small_img, small_nd, 6.0, 0.0, 1.0, True)
    small_ms = (time.perf_counter() - t0) * 1e3
    small_differ = int((small != plain).sum())
    log("17-host-kernel", eye="1080x1920 sharp +24px", bytes_differ_k2=differ,
        host_ms=f"{min(times):.1f}", host_ms_runs=[f"{t:.1f}" for t in times],
        k2_ms=f"{k2_ms:.4f}", cpu_threads=os.cpu_count(),
        small="270x480 +6px", bytes_differ_plain=small_differ,
        host_small_ms=f"{small_ms:.1f}", plain_small_ms=f"{plain_ms:.1f}")
    if differ or small_differ:
        raise AssertionError(f"17 host kernel: {differ} bytes differ from "
                             f"K2, {small_differ} from polylines_plain")


def phase_rest(profile: bool = False):
    """The REST server (frontends/api.py make_server) on a thread of this
    process at full width, random weights from seed 0: the info routes;
    POST /depth/generate with phase 4's images (4 x 512^2 + 1080p) on
    dpt_beit_large_512 with polylines_sharp stereo, then the default
    options (DA v2 Base) on the 1080p image, each byte-equal to a direct
    funnel call with the same launches; /depth/generate/video on one
    512^2 image (the 3D photo from seeded checkpoints, a GIF trajectory);
    the error routes; the same default-options request through `python -m
    depthmap_tpu_torch.cli --serve`; the UI's run_generate on BEiT +
    stereo; the host polylines kernel against K2.  Returns {path: K1
    launches}, {path: K2 sweeps}."""
    import tempfile
    import threading
    import torch
    from PIL import Image
    from depthmap_tpu_torch.frontends import api, gradio_ui
    from depthmap_tpu_torch.models.weights import \
        save_random_inpaint_checkpoints
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline import core
    images = _test_images(3, [(512, 512)] * 4 + [(1080, 1920)])
    b64 = [_png_b64(i) for i in images]
    srv = api.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    cwd = os.getcwd()
    k1_by_path, k2_by_path = {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            status, body = _http(base + "/depth/version")
            if status != 200 or body != {"version": api.SCRIPT_VERSION}:
                raise AssertionError(f"17 version: {status} {body}")
            status, body = _http(base + "/depth/get_options")
            if status != 200 or body["options"] != sorted(
                    GenerationOptions.field_names()):
                raise AssertionError(f"17 get_options: {status} {body}")
            beit = {"model_type": 1, "net_width": 512, "net_height": 512,
                    "gen_stereo": True,
                    "stereo_modes": ["left-right", "red-cyan-anaglyph"],
                    "stereo_fill_algo": "polylines_sharp"}
            blocks = 24
            _, k1, k2 = rest_generate(
                base, "dpt_beit_large_512", {"depth_input_images": b64,
                                             "options": beit,
                                             "outpath": tmp},
                blocks * 2, 2 * len(images))
            k1_by_path["rest_dpt_beit_large_512"] = k1
            k2_by_path["rest_dpt_beit_large_512"] = k2
            defaults = {"depth_input_images": b64[-1:], "options": {},
                        "outpath": tmp}
            default_pngs, k1, _ = rest_generate(
                base, "default_options_da_v2_base", defaults, 12, 0)
            k1_by_path["rest_default_options_da_v2_base"] = k1

            # the video route: the 3D photo from ./models/3dphoto
            save_random_inpaint_checkpoints(
                os.path.join(tmp, "models", "3dphoto"), seed=17)
            os.chdir(tmp)
            video = os.path.join(tmp, "video", "traj.gif")
            t0 = time.perf_counter()
            status, body = _http(base + "/depth/generate/video", {
                "depth_input_images": b64[:1], "outpath": tmp, "options": {
                    "model_type": "depth_anything_v2_base",
                    "video_parameters": {
                        "vid_numframes": REST_VIDEO_FRAMES, "vid_fps": 8,
                        "vid_traj": 1, "vid_shift": "-0.015, 0.0, -0.05",
                        "vid_border": "0.03, 0.03, 0.05, 0.03",
                        "dolly": False, "vid_format": "gif", "vid_ssaa": 1,
                        "output_filename": video}}})
            video_s = time.perf_counter() - t0
            os.chdir(cwd)
            written = sorted(os.listdir(os.path.dirname(video))) \
                if os.path.isdir(os.path.dirname(video)) else []
            if status != 200 or body != {"info": "Success"} or \
                    not written or not os.path.getsize(
                        os.path.join(os.path.dirname(video), written[0])):
                raise AssertionError(f"17 video: {status} {body} {written}")
            log("17-rest", request="video", status=status,
                s_per_request=f"{video_s:.2f}", frames=REST_VIDEO_FRAMES,
                written=written)

            for label, url, payload, want in (
                    ("no_images", "/depth/generate",
                     {"depth_input_images": []}, 422),
                    ("unknown_model", "/depth/generate/video",
                     {"depth_input_images": b64[:1],
                      "options": {"model_type": "nope"}}, 400),
                    ("not_found", "/depth/nope", None, 404)):
                status, body = _http(base + url, payload)
                if status != want:
                    raise AssertionError(f"17 {label}: {status} {body}")
            status, body = _http(base + "/depth/generate", data=b"{}",
                                 headers={"Content-Length": str(
                                     api.Handler.MAX_BODY_BYTES + 1)})
            if status != 413:
                raise AssertionError(f"17 413: {status} {body}")
            if not thread.is_alive():
                raise AssertionError("17: the server thread died")
            log("17-rest", errors="422 400 404 413", thread_alive=True)

            rest_subprocess(defaults, default_pngs)

            # the UI's run_generate with the panel's options
            named = dict(GenerationOptions(
                model_type=1, net_width=512, net_height=512, gen_stereo=True,
                stereo_fill_algo="polylines_sharp").to_dict(),
                depthmap_mode="0", custom_depthmap=False, save_outputs=True,
                depthmap_input_image=Image.fromarray(images[0]))
            _zero_counts()
            t0 = time.perf_counter()
            gallery, _, _, html = gradio_ui.run_generate(
                named, outpath=os.path.join(tmp, "ui"))
            ui_s = time.perf_counter() - t0
            ui_k1 = _counts()[0]
            if "ERROR" in html or len(gallery) != 3 or ui_k1 != blocks:
                raise AssertionError(f"17 run_generate: {html[:300]} "
                                     f"{len(gallery)} {ui_k1}")
            log("17-ui", run_generate="BEiT + stereo, 512^2",
                s=f"{ui_s:.3f}", gallery=len(gallery), k1_launches=ui_k1)
    finally:
        os.chdir(cwd)
        srv.shutdown()
        srv.server_close()
        core._default_cache.release()
        torch.cuda.empty_cache()
    rest_host_kernel()
    return k1_by_path, k2_by_path


# -- phase 18: K1's gradient, the train step, the splits, the graft entry ---

# K1's gradient (phase 18a): dq, dk, dv and dbias of FlashAttentionFunction
# (K1's f32 body forward, the backward in f32 torch) against the function's
# own by autograd in f64, each within this share of the gradient's largest
# magnitude.  The split-TF32 forward errs ~1e-6 of its outputs and the f32
# backward a few ulps of its sums; a detached output (no gradient at all,
# the parent's behaviour) and a backward without the rowsum term D each
# break it.
K1_GRAD_BOUND = 1e-4
# (name, batch, heads, N, bias batch): the train step's BEiT-L call, one
# bias shared by the batch and requiring grad; a bias-free ViT-B shape
K1_GRAD_CASES = [("f32_b2_h16_n1025_shared", 2, 16, 1025, 1),
                 ("f32_b4_h12_n1025_none", 4, 12, 1025, 0)]
# the train step's loss and gradients (phase 18b) against the same step with
# attention through the plain version: K1's f32 forward errs <= 5e-5 of an
# attention output (K1_F32_ACCURACY), ~1e-6 typically; the loss takes
# log(max(pred, 0) + 1e-3), whose gradient moves by d / 1e-3 of itself
# where pred is near 0 and the forwards differ by d, so a parameter's
# gradient may move by ~1e-3 of its largest (tests/test_torch_port_train
# .py, STEP_GRAD_RTOL); 2e-2 leaves room for 24 blocks at full width
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 2e-2
TRAIN_STEPS = 3
# a split over [cuda:0, cuda:0] against the unsplit bf16 forward of the
# whole batch: each shard's GEMMs run at half the rows, where cuBLAS may
# take other kernels and sum in another order, and a bf16 output rounds
# (2^-8) after each; max |d| within 5e-2 and the mean within 5e-3 of the
# map's range.  Against the same shards run unsplit: byte-equal.
SPLIT_BF16_RTOL = 5e-2
SPLIT_BF16_MEAN_RTOL = 5e-3
# Marigold's members, split against unsplit, f32 (maps in [0, 1])
SPLIT_MARIGOLD_ATOL = 1e-4
# Boost's map, split against unsplit (maps in [0, 1]): the JAX dryrun's
# bound.  Each device's share of a chunk is an unsplit chunk, but the
# crops' and the blend's resamplers sum with atomics on the card, so two
# runs of one chunk may differ in the last bits
SPLIT_BOOST_ATOL = 1e-5


def k1_grad_reference(ins, dout):
    """dq, dk, dv (, dbias) of softmax(q.k^T / 8 + bias).v by autograd in
    f64 (the plain version's function), from f32 inputs."""
    import torch
    ref = [t.detach().double().requires_grad_() for t in ins]
    s = ref[0] @ ref[1].transpose(-1, -2) * 64 ** -0.5
    if len(ref) > 3:
        s = s + ref[3]
    out = torch.softmax(s, -1) @ ref[2]
    return torch.autograd.grad((out * dout.double()).sum(), ref)


def k1_grads_without_rowsum(q, k, v, bias, dout):
    """A planted fault: the backward with dS = P * dP (the rowsum term D
    left out), summed over the batch for a shared bias."""
    import torch
    s = q @ k.transpose(-1, -2) * 64 ** -0.5
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, -1)
    ds = p * (dout @ v.transpose(-1, -2))
    grads = [ds @ k * 64 ** -0.5, ds.transpose(-1, -2) @ q * 64 ** -0.5,
             p.transpose(-1, -2) @ dout]
    if bias is not None:
        grads.append(ds.sum(0, keepdim=True) if bias.shape[0] == 1 else ds)
    return grads


def grad_error(got, want) -> float:
    """The largest error of any gradient as a share of its largest
    magnitude."""
    return max((g.double() - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))


def phase_k1_grad():
    """K1's gradient at the train shapes (18a): the Function's dq, dk, dv,
    dbias against autograd in f64, two planted faults, and the backward's
    ms beside the forward's, autograd through the plain version's, and
    SDPA efficient's forward + backward (a yardstick; the port never
    calls it)."""
    import torch
    import torch.nn.functional as F
    from depthmap_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(18)
    out_rows = []
    for name, b, h, n, bb in K1_GRAD_CASES:
        def mk(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).cuda()
        q, k = mk(b, h, n, 64, scale=K1_Q_SCALE), mk(b, h, n, 64)
        v = mk(b, h, n, 64, scale=K1_V_SCALE)
        dense = mk(bb, h, n, n) if bb else None
        dout = mk(b, h, n, 64)
        ins = [t.requires_grad_() for t in (q, k, v)] + (
            [dense.requires_grad_()] if bb else [])

        def biased():
            return fa.pad_bias_rows(dense) if bb else None
        before = fa.flash_attention_cuda.launches_by_dtype["float32"]
        out = fa.flash_attention(q, k, v, biased())
        launched = fa.flash_attention_cuda.launches_by_dtype["float32"] - \
            before
        if launched != 1 or out.grad_fn is None:
            raise AssertionError(f"18a {name}: K1's f32 body launched "
                                 f"{launched} times, grad_fn {out.grad_fn}")
        got = torch.autograd.grad((out * dout).sum(), ins)
        want = k1_grad_reference(ins, dout)
        err = grad_error(got, want)
        # the parent's output: no graph, so no gradient reaches an input
        assert not out.detach().requires_grad
        faults = {
            "detached": grad_error([torch.zeros_like(w) for w in want],
                                   want),
            "no_rowsum": grad_error(k1_grads_without_rowsum(
                *(t.detach() for t in (q, k, v)),
                dense.detach() if bb else None, dout), want)}
        del want
        torch.cuda.empty_cache()
        qd, kd, vd = (t.detach() for t in (q, k, v))
        bias_d = fa.pad_bias_rows(dense.detach()) if bb else None
        outd = out.detach()
        fwd_ms = cuda_ms(lambda: fa.flash_attention_cuda(qd, kd, vd, bias_d),
                         10)
        bwd_ms = cuda_ms(lambda: fa.attention_grads(qd, kd, vd, bias_d, outd,
                                                    dout, 0.125), 5)

        def fwd_bwd(fn):
            def call():
                o = fn(q, k, v, biased())
                return torch.autograd.grad((o * dout).sum(), ins)
            return call
        both_ms = cuda_ms(fwd_bwd(fa.flash_attention), 5)
        plain_ms = cuda_ms(fwd_bwd(fa.flash_attention_plain), 3)
        try:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                sdpa_ms = cuda_ms(fwd_bwd(F.scaled_dot_product_attention),
                                  5)
            sdpa_ms = f"{sdpa_ms:.4f}"
        except RuntimeError:
            sdpa_ms = "refused"
        # the backward's bytes: q, k, v, O, dO (and the bias) read, dq, dk,
        # dv (and dbias) written, and P recomputed: 4 B N D (1 + 1 + 1) for
        # q.k^T, dO.v^T, dS.k, dS^T.q, P^T.dO: 5 products of 2 B H N N D
        nbytes = 4 * (8 * b * h * n * 64 + (2 * bb * h * n * n if bb else 0))
        flops = 5 * 2 * b * h * n * n * 64
        bwd_bound, basis = bound(nbytes, flops, "float32")
        fwd_bound = k1_bound(b, h, n, n, bb, "float32")[1]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("18a-k1-grad", case=name, rel_err=f"{err:.3e}",
            bound=K1_GRAD_BOUND,
            **{f"fault_{f}_rel_err": f"{e:.3e}" for f, e in faults.items()},
            fwd_ms=f"{fwd_ms:.4f}",
            fwd_split_tf32_bound_us=f"{fwd_bound[0] * 1e3:.1f}",
            fwd_bound_by=fwd_bound[1], bwd_ms=f"{bwd_ms:.4f}",
            fwd_bwd_ms=f"{both_ms:.4f}", plain_fwd_bwd_ms=f"{plain_ms:.4f}",
            sdpa_efficient_fwd_bwd_ms=sdpa_ms,
            bwd_bound_us=f"{bwd_bound * 1e3:.1f}", bwd_bound_by=basis,
            bwd_share_of_f32_bound=f"{bwd_bound / bwd_ms:.3f}",
            max_memory_allocated_GiB=f"{peak:.3f}")
        if not err <= K1_GRAD_BOUND:
            raise AssertionError(f"18a {name}: gradient error {err} > "
                                 f"{K1_GRAD_BOUND}")
        if not min(faults.values()) > K1_GRAD_BOUND:
            raise AssertionError(f"18a {name}: a planted fault passes the "
                                 f"bound: {faults}")
        out_rows.append(dict(case=name, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                             rel_err=err))
        del q, k, v, dense, dout, ins, out, got, outd, bias_d
        torch.cuda.empty_cache()
    return out_rows


class plain_attention:
    """Inside: every ViT attention runs flash_attention_plain (autograd
    through its own ops), for the train step's reference only."""

    def __enter__(self):
        from depthmap_tpu_torch.models import attention as att
        from depthmap_tpu_torch.ops import flash_attention as fa
        self.orig = att.flash_attention
        att.flash_attention = fa.flash_attention_plain

    def __exit__(self, *exc):
        from depthmap_tpu_torch.models import attention as att
        att.flash_attention = self.orig


def phase_train_step():
    """The graft entry on the card (18d: its forward, 24 K1 f32 launches,
    a finite map), then the train step at full width (18b) on the entry's
    model: dpt_beit_large_512 in f32 on a (1, 1) mesh over NCCL at world
    1, Adam 1e-4, a batch of 2 x 512^2 (images ~ N(0, 1), targets U(0, 1)
    + 0.5, as the dryrun draws them); step 1's loss and gradients against
    the same step with attention through the plain version; TRAIN_STEPS
    timed steps, each with its counts set to 0 just before it: a finite
    loss and 24 K1 f32 launches (the forward's; the backward launches
    none).  Returns the entry's and the steps' K1 launches and the model."""
    import functools
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from depthmap_tpu_torch import graft_entry
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.parallel import mesh as pm
    from depthmap_tpu_torch.parallel.train import depth_loss, make_train_step
    t0 = time.perf_counter()
    fn, (module, x) = graft_entry.entry()
    build_s = time.perf_counter() - t0
    fn(module, x)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    depth = fn(module, x)
    torch.cuda.synchronize()
    entry_ms = (time.perf_counter() - t0) * 1e3
    entry_k1 = fa.flash_attention_cuda.launches_by_dtype["float32"]
    log("18d-entry", build_s=f"{build_s:.2f}", forward_ms=f"{entry_ms:.2f}",
        shape=tuple(depth.shape), dtype=str(depth.dtype),
        k1_f32_launches=entry_k1, finite=bool(torch.isfinite(depth).all()))
    if tuple(depth.shape) != (1, 512, 512) or \
            not torch.isfinite(depth).all() or entry_k1 != 24 or \
            fa.flash_attention_cuda.launches != 24:
        raise AssertionError(f"18d: entry() gave {tuple(depth.shape)}, K1 "
                             f"{fa.flash_attention_cuda.launches_by_dtype}")
    del depth, x
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(2, 512, 512, 3)).transpose(
        0, 3, 1, 2).astype(np.float32)).contiguous().cuda()
    targets = torch.from_numpy((rng.random((2, 512, 512)) + 0.5).astype(
        np.float32)).cuda()
    torch.cuda.reset_peak_memory_stats()
    with plain_attention():
        ref_loss = depth_loss(module(images), targets)
        ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    ref = {k: p.grad for k, p in module.named_parameters()}
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    module.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    launches = 0
    with tempfile.TemporaryDirectory() as store:
        pm.init_process_group(0, 1, store, "cuda", 300.0)
        try:
            mesh = pm.make_mesh(1, 1, "cuda")
            step = make_train_step(module, functools.partial(
                torch.optim.Adam, lr=1e-4), mesh)
            for i in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_counts()
                t0 = time.perf_counter()
                loss = float(step(images, targets))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                k1 = fa.flash_attention_cuda.launches
                k1_f32 = fa.flash_attention_cuda.launches_by_dtype["float32"]
                peak = torch.cuda.max_memory_allocated() / 2**30
                extra = {}
                if i == 0:
                    errs = {k: grad_error([p.grad], [ref[k]])
                            if ref[k].abs().max().item() > 0 else
                            p.grad.abs().max().item()
                            for k, p in module.named_parameters()}
                    worst = max(errs, key=errs.get)
                    watched = [k for k in errs if k.endswith((
                        "relative_position_bias_table", "qkv.weight",
                        "q_bias", "v_bias"))]
                    zero = [k for k in watched
                            if not ref[k].abs().max().item() > 0 or
                            not module.get_parameter(k).grad.abs().max()
                            .item() > 0]
                    extra = dict(ref_loss=f"{ref_loss:.6f}",
                                 grad_rel_err_max=f"{errs[worst]:.3e}",
                                 grad_worst=worst, grads_checked=len(errs),
                                 watched_nonzero=len(watched) - len(zero),
                                 ref_peak_GiB=f"{ref_peak:.3f}")
                log("18b-train", step=i + 1, loss=f"{loss:.6f}",
                    s_per_step=f"{seconds:.3f}", k1_launches=k1,
                    k1_f32_launches=k1_f32,
                    max_memory_allocated_GiB=f"{peak:.3f}", **extra)
                if not np.isfinite(loss) or k1 != 24 or k1_f32 != 24:
                    raise AssertionError(f"18b step {i + 1}: loss {loss}, "
                                         f"K1 {k1} ({k1_f32} f32)")
                if i == 0:
                    if abs(loss - ref_loss) > TRAIN_LOSS_RTOL * abs(ref_loss):
                        raise AssertionError(f"18b: loss {loss} against the "
                                             f"plain version's {ref_loss}")
                    if errs[worst] > TRAIN_GRAD_RTOL:
                        raise AssertionError(f"18b: {worst}'s gradient errs "
                                             f"{errs[worst]}")
                    if len(watched) != 4 * 24 or zero:
                        raise AssertionError(f"18b: {len(watched)} watched, "
                                             f"zero gradients: {zero}")
                    del ref
                launches += k1
        finally:
            dist.destroy_process_group()
    del step, images, targets
    module.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return entry_k1, launches, module


def _timed(fn, runs: int = 1):
    """(fn()'s output, its mean ms over ``runs`` calls, host clock to a
    synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / runs


def _bf16_close(label, got, want):
    import numpy as np
    span = float(np.ptp(want))
    d = np.abs(got - want)
    if not (span > 0 and d.max() <= SPLIT_BF16_RTOL * span and
            d.mean() <= SPLIT_BF16_MEAN_RTOL * span):
        raise AssertionError(f"18c {label}: split vs unsplit max "
                             f"{d.max() / span:.3e}, mean "
                             f"{d.mean() / span:.3e} of the range")
    return f"{d.max() / span:.3e}", f"{d.mean() / span:.3e}"


def phase_splits(module, device: str = "cuda:0"):
    """Each split forced over [cuda:0, cuda:0] (one card: the math of the
    split, not its speed) against its unsplit run, with ms for both and
    the split run's launches counted from 0 (18c): predict_batch of
    BEiT-L 512 bf16 (phase 18b's weights) on 4 x 512^2; Boost on it on a
    textured 384 x 512 image at r_max 1024; Marigold's members at res 64, ensemble 4, 2
    steps, f32 (phase 14's weights); K2's rows on phase 3's 1080p eye."""
    import dataclasses
    import functools
    from unittest import mock
    import numpy as np
    import torch
    from depthmap_tpu_torch.models.marigold.pipeline import MarigoldPipeline
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.ops import polylines as pl
    from depthmap_tpu_torch.parallel import mesh
    from depthmap_tpu_torch.pipeline.boost import BoostEngine
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    one = [torch.device(device)]
    two = one * 2
    launches = {}
    with torch.device("meta"):
        bundle = dataclasses.replace(build_model(1), module=module)
    pred = DepthPredictor(1, state_dict=module.state_dict(), bundle=bundle,
                          device=device, devices=two)
    frames = np.stack(_test_images(40, [(512, 512)] * 4)).astype(
        np.float32) / 255.0
    pred.predict_batch(frames, 512, 512)
    _zero_counts()
    split = pred.predict_batch(frames, 512, 512)
    launches["split_predict_batch"] = fa.flash_attention_cuda.launches
    _, split_ms = _timed(lambda: pred.predict_batch(frames, 512, 512), 3)
    pred.devices = one
    pred.predict_batch(frames, 512, 512)     # the whole batch's shapes warm
    halves, halves_ms = _timed(lambda: np.concatenate(
        [pred.predict_batch(frames[:2], 512, 512),
         pred.predict_batch(frames[2:], 512, 512)]), 3)
    whole, whole_ms = _timed(lambda: pred.predict_batch(frames, 512, 512),
                             3)
    mx, mean = _bf16_close("predict_batch", split, whole)
    log("18c-split", path="predict_batch", model="dpt_beit_large_512",
        dtype=str(pred.compute_dtype), frames=4,
        devices=",".join(map(str, two)),
        k1_launches=launches["split_predict_batch"], split_ms=f"{split_ms:.2f}",
        unsplit_ms=f"{whole_ms:.2f}", halves_ms=f"{halves_ms:.2f}",
        equal_to_halves=bool(np.array_equal(split, halves)),
        max_rel=mx, mean_rel=mean)
    if launches["split_predict_batch"] != 48 or \
            not np.array_equal(split, halves):
        raise AssertionError("18c predict_batch: K1 "
                             f"{launches['split_predict_batch']}, or the "
                             "split differs from its shards run unsplit")

    img = _textured(31, 384, 512).astype(np.float32) / 255.0
    engine = BoostEngine(pred, seed=3)
    pred.devices = two
    estimate = functools.partial(engine.estimate, img,
                                 whole_size_threshold=1024)
    estimate()
    _zero_counts()
    boost_split, boost_split_ms = _timed(estimate)
    launches["split_boost"] = fa.flash_attention_cuda.launches
    launches["split_boost_rel"] = \
        fa.flash_attention_cuda.launches_by_mode["rel"]
    run = dict(engine.last_run)
    pred.devices = one
    boost_one, boost_ms = _timed(estimate)
    d = float(np.abs(boost_split - boost_one).max())
    log("18c-split", path="boost", model="dpt_beit_large_512",
        size="384x512", R_x=run["whole_size"], patches=run["patches"],
        chunks=run["chunks"], k1_launches=launches["split_boost"],
        k1_rel_launches=launches["split_boost_rel"],
        split_ms=f"{boost_split_ms:.2f}", unsplit_ms=f"{boost_ms:.2f}",
        max_abs_diff=f"{d:.3e}", atol=SPLIT_BOOST_ATOL)
    want = 24 * (2 + 2 * 2 * run["chunks"])
    if launches["split_boost"] != want or not d <= SPLIT_BOOST_ATOL:
        raise AssertionError(f"18c Boost: K1 {launches['split_boost']} "
                             f"(expected {want}), or the split differs")
    del pred, engine
    torch.cuda.empty_cache()

    pipe = empty_bundle(10).module
    pipe.load_state_dict(_KEEP.pop("marigold_sd"))
    pipe = pipe.cuda().eval()
    mimg = _test_images(41, [(48, 64)])[0].astype(np.float32) / 255.0
    noise = torch.randn((4, 4, 6, 8), generator=torch.Generator()
                        .manual_seed(41))
    members = lambda **kw: pipe.members(mimg, processing_res=64,  # noqa
                                        ensemble_size=4, denoising_steps=2,
                                        **kw)
    if MarigoldPipeline.ensemble_devices(4, two) != two:
        raise AssertionError("18c Marigold: 4 members do not split over 2")
    members(noise=noise, devices=two)
    _zero_counts()
    m_split, m_split_ms = _timed(lambda: members(noise=noise, devices=two))
    launches["split_marigold"] = fa.flash_attention_cuda.launches
    m_halves = np.concatenate([pipe.members(
        mimg, processing_res=64, ensemble_size=2, denoising_steps=2,
        noise=z) for z in noise.chunk(2)])
    members(noise=noise)                      # the whole batch's shapes warm
    m_one, m_ms = _timed(lambda: members(noise=noise))
    d = float(np.abs(m_split - m_one).max())
    log("18c-split", path="marigold_members", res=64, ensemble=4, steps=2,
        dtype=str(pipe.compute_dtype), k1_launches=launches["split_marigold"],
        split_ms=f"{m_split_ms:.2f}", unsplit_ms=f"{m_ms:.2f}",
        max_abs_diff=f"{d:.3e}", atol=SPLIT_MARIGOLD_ATOL,
        equal_to_halves=bool(np.array_equal(m_split, m_halves)))
    if launches["split_marigold"] != 32 * 2 * 2 or \
            not d <= SPLIT_MARIGOLD_ATOL or m_split.shape != (4, 48, 64) \
            or not np.array_equal(m_split, m_halves):
        raise AssertionError(f"18c Marigold: K1 "
                             f"{launches['split_marigold']}, max |d| {d}")
    del pipe
    torch.cuda.empty_cache()

    eye_img, eye_nd, div, eye = _KEEP.pop("k2_eye")
    args = (div, 0.0, 1.0, True)
    eye_ms = cuda_ms(lambda: pl.polylines_rasterize(
        eye_img, eye_nd, *args, shard=False), 5)
    # two visible cards, as the row split sees them: the one card twice
    with mock.patch.object(mesh, "local_devices", lambda device="cuda": two):
        pl.polylines_rasterize(eye_img, eye_nd, *args)
        _zero_counts()
        eye_split = pl.polylines_rasterize(eye_img, eye_nd, *args)
        torch.cuda.synchronize()
        launches["split_k2"] = (pl._sort_cuda.launches,
                                pl._sweep_cuda.launches)
        eye_split_ms = cuda_ms(lambda: pl.polylines_rasterize(
            eye_img, eye_nd, *args), 5)
    ndiff = int((eye_split != eye).sum())
    log("18c-split", path="k2_rows", shape="1080x1920", divergence_px=div,
        sorts=launches["split_k2"][0], sweeps=launches["split_k2"][1],
        split_ms=f"{eye_split_ms:.3f}", unsplit_ms=f"{eye_ms:.3f}",
        bytes_differ=ndiff)
    if ndiff or launches["split_k2"] != (2, 2):
        raise AssertionError(f"18c K2: {ndiff} bytes differ from phase 3's "
                             f"eye, launches {launches['split_k2']}")
    return launches


def phase_parallel():
    """Phase 18: K1's gradient (18a), the train step (18b) with the graft
    entry's forward (18d) first, the splits over a repeated card (18c),
    then dryrun_multichip(2) on the CPU (18d)."""
    import torch
    from depthmap_tpu_torch import graft_entry
    k1_grad = phase_k1_grad()
    with k1_shapes() as shapes:
        entry_k1, train_k1, module = phase_train_step()
        launches = phase_splits(module)
    del module
    torch.cuda.empty_cache()
    check_k1_shapes("18", shapes.seen)
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2)
    log("18d-dryrun", n_devices=2, s=f"{time.perf_counter() - t0:.1f}")
    k1_by_path = {"graft_entry": entry_k1, "train_step_beit_large_512":
                  train_k1, "split_predict_batch":
                  launches["split_predict_batch"],
                  "split_boost": launches["split_boost"],
                  "split_marigold": launches["split_marigold"]}
    return (k1_by_path, {"split_boost": launches["split_boost_rel"]},
            launches["split_k2"][1], k1_grad)


# phase 19: BEiT-L 512's net sizes (one block's bf16 bias: 0.54, 3.2 and
# 8.6 GB), and a stream budget over every one of them (the inline tier)
STREAM_NET_SIZES = (1024, 1600, 2048)
INLINE_BUDGET = 1 << 40


def streamed_tiers(pred, img, size: int, build_s: float,
                   profile: bool = False):
    """Phase 19 at one net size: a warm and a timed forward in each tier,
    checked as ``phase_streamed`` says (with ``profile``, a profile of the
    streamed forward at the largest size); the timed runs' K1 launches and
    those in table mode."""
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    n = (size // 16) ** 2 + 1
    bias_bytes = 16 * n * n * 2
    runs = {}
    for tier in ("streamed", "inline"):
        if tier == "inline":
            os.environ["DEPTHMAP_BIAS_STREAM_BYTES"] = str(INLINE_BUDGET)
        pred._forward(img, size, size)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        depth = pred._forward(img, size, size)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        os.environ.pop("DEPTHMAP_BIAS_STREAM_BYTES", None)
        peak = torch.cuda.max_memory_allocated() - base
        modes = dict(fa.flash_attention_cuda.launches_by_mode)
        runs[tier] = (depth, peak, modes, fa.flash_attention_cuda.launches)
        log("19-streamed", tier=tier, net=f"{size}x{size}", n=n,
            forward_ms=f"{ms:.2f}", k1_by_mode=modes,
            peak_over_weights_GiB=f"{peak / 2**30:.3f}",
            one_block_bias_GiB=f"{bias_bytes / 2**30:.3f}",
            build_s=f"{build_s:.1f}")
        if profile and tier == "streamed" and size == max(STREAM_NET_SIZES):
            profile_call(f"19_streamed_{size}x{size}",
                         lambda: pred._forward(img, size, size))
    (ds, ps, ms_, ls), (di, pi, mi, li) = runs["streamed"], runs["inline"]
    equal = bool(torch.equal(ds, di))
    log("19-streamed", net=f"{size}x{size}", maps_equal=equal,
        peak_inline_minus_streamed_GiB=f"{(pi - ps) / 2**30:.3f}")
    if not equal or ms_ != {"none": 0, "bias": 0, "rel": 24} or \
            mi != {"none": 0, "bias": 24, "rel": 0} or \
            tuple(ds.shape) != (1, 1024, 1024) or \
            not torch.isfinite(ds).all() or \
            not float(ds.max() - ds.min()) > 0:
        raise AssertionError(f"19 at {size}^2: maps equal {equal}, "
                             f"K1 {ms_} / {mi}, {tuple(ds.shape)}")
    if size == 2048 and not ps < bias_bytes <= pi:
        raise AssertionError(f"19 at 2048^2: peaks {ps} (streamed) and "
                             f"{pi} (inline) against one block's bias "
                             f"{bias_bytes}")
    return ls + li, ms_["rel"] + mi["rel"]


def phase_streamed(profile: bool = False):
    """Phase 19: dpt_beit_large_512 (bf16, random weights from seed 0)
    through the predictor on one textured 1024^2 image at net 1024^2,
    1600^2 and 2048^2 (N = 4097, 10001, 16385), in the streamed tier (the
    default stream budget) and in the inline tier (DEPTHMAP_BIAS_STREAM_
    BYTES = INLINE_BUDGET): each a warm forward, then a timed one with
    every count set to 0 just before it.  The maps must be byte-equal
    between the tiers; the streamed forwards launch K1 24 times in table
    mode, the inline ones 24 times with a materialized bias; at 2048^2 the
    streamed forward's peak allocation over the weights stays under one
    block's bias (no (H, N, N) tensor), the inline one's reaches it; every
    K1 shape is held by phase 2.  Returns the timed runs' K1 launches and
    those in table mode."""
    import tempfile
    import numpy as np
    import torch
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as empty:
        pred = DepthPredictor(1, weights_dir=empty, seed=0, device="cuda")
    build_s = time.perf_counter() - t0
    img = torch.from_numpy(_textured(19, 1024, 1024).astype(np.float32)
                           / 255.0).cuda()[None]
    launches = rel = 0
    with k1_shapes() as shapes:
        try:
            for size in STREAM_NET_SIZES:
                k1, k1_rel = streamed_tiers(pred, img, size, build_s,
                                            profile)
                launches, rel = launches + k1, rel + k1_rel
        finally:
            os.environ.pop("DEPTHMAP_BIAS_STREAM_BYTES", None)
    check_k1_shapes("19", shapes.seen)
    del pred, img
    torch.cuda.empty_cache()
    return launches, rel


# the phases --phase runs alone (those that profile their paths and need
# no earlier phase)
STANDALONE_PHASES = {
    "4": phase_main_path, "6": phase_default_options, "7": phase_long_n,
    "9": phase_dpt_large, "10": phase_zoo, "12": phase_metric_zoo,
    "13": phase_boost, "14": phase_marigold, "15": phase_video,
    "16": phase_3dphoto, "17": phase_rest, "19": phase_streamed}


def run_phases(phases, profile: bool) -> int:
    """``--phase A,B``: the environment, the build, then those phases alone
    (with ``--profile``, whose profiles must see every launch), and no
    result lines."""
    phase_environment()
    phase_build()
    for phase in phases:
        t0 = time.perf_counter()
        _PROFILE["phase"] = phase
        STANDALONE_PHASES[phase](profile)
        log("phase-alone", name=phase,
            seconds=round(time.perf_counter() - t0, 1))
    return 0


def profile_again():
    """Profile in a fresh process each phase whose profiles lost a launch
    here; fails where that process fails."""
    import torch
    for phase in sorted(_PROFILE["again"], key=int):
        log("profile-again", name=phase, reason="a profile lost a launch")
        torch.cuda.empty_cache()
        sys.stdout.flush()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--profile", "--phase", phase], check=True,
                       timeout=3600)


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    if "--phase" in args:
        phases = args[args.index("--phase") + 1].split(",")
        unknown = [p for p in phases if p not in STANDALONE_PHASES]
        if unknown:
            known = sorted(STANDALONE_PHASES, key=int)
            raise SystemExit(f"--phase takes {known}, not {unknown}")
        return run_phases(phases, profile)
    _PROFILE["again"] = set()
    seconds = {}

    def timed(label, fn, *args):
        _PROFILE["phase"] = label
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out
    smi = timed("0", phase_environment)
    timed("1", phase_build)
    k1_err, k1, k1_f32, k1_rel = timed("2", phase_k1)
    k1_alpha = timed("2a", phase_k1_alpha)
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
    k1_by_path["boost_dpt_beit_large_512"], rel_boost = timed(
        "13", phase_boost, profile)
    # K1's table-mode launches on the paths that stream a BEiT bias
    k1_rel_by_path = {"boost_dpt_beit_large_512": rel_boost}
    marigold, marigold_f32 = timed("14", phase_marigold, profile)
    k1_by_path.update({f"marigold_{dt}": n for dt, n in marigold.items()})
    # the f32 body's launches, read on the Marigold paths (the other model
    # paths run K1 in bf16)
    k1_f32_by_path = {f"marigold_{dt}": n for dt, n in marigold_f32.items()}
    k1_by_path["video_pass1_da_v2_base"], k2_video = timed(
        "15", phase_video, profile)
    k1_by_path["3dphoto_da_v2_base"] = timed("16", phase_3dphoto, profile)
    k2_by_path = {"dpt_beit_large_512": k2_launches, "video_pass2": k2_video}
    k1_rest, k2_rest = timed("17", phase_rest, profile)
    k1_by_path.update(k1_rest)
    k2_by_path.update(k2_rest)
    k1_parallel, k1_rel_parallel, k2_by_path["split_1080p_eye"], k1_grad = \
        timed("18", phase_parallel)
    k1_by_path.update(k1_parallel)
    k1_rel_by_path.update(k1_rel_parallel)
    (k1_by_path["streamed_bias_beit_large_512"],
     k1_rel_by_path["streamed_bias_beit_large_512"]) = timed(
        "19", phase_streamed, profile)
    profile_again()
    k1_f32_by_path.update(train_step_beit_large_512=k1_parallel[
        "train_step_beit_large_512"], graft_entry=k1_parallel["graft_entry"])
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
            device_ms=k1["device_ms"], launches_by_path=k1_by_path,
            launches_f32_by_path=k1_f32_by_path, f32_main=k1_f32,
            gradient=k1_grad, launches_rel_by_path=k1_rel_by_path,
            table_mode=k1_rel,
            bf16_alpha_signed_mean=k1_alpha["kernel"][0],
            bf16_alpha_stderr=k1_alpha["kernel"][1]),
        # K2's launches: its sweep's, one per eye of the BEiT paths' (the
        # funnel's and the REST request's) and of video mode's polylines
        # stereo (each eye also launched one sort, checked there), per
        # path beside it
        row("polylines", K2_SOURCE, K2_REPLACES,
            sum(k2_by_path.values()), k2_err, k2,
            launches_by_path=k2_by_path),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
