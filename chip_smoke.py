#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line with its numbers; any failure exits non-zero
and prints no result):
  0. environment: CUDA required; torch / CUDA versions, the card's name
     and power limit from nvidia-smi, whether PIL and cv2 import;
  1. build: nvcc builds both hand-written kernels from csrc/;
  2. K1 (flash attention) against its plain version at the main path's
     shapes, bf16 and f32, with and without bias;
  3. K2 (polylines) against its plain version at 1080x1920, byte-exact;
  4. main path: dpt_beit_large_512 at full width (24 blocks, 1024 wide,
     random init from a seed, bf16) through PredictorCache and
     core_generation_funnel: 4 images of 512x512 (batched pre-pass) and one
     of 1920x1080 (serial path, inline per-block bias, table resize), with
     depth, left-right and red-cyan-anaglyph outputs; the kernels' launch
     counts must show the path ran through them;
  5. whole-path numerics: one 512x512 image through the predictor in f32
     on the card (kernels, TF32 off) and on the CPU (plain versions).
The last lines: the card's name and power limit, a JSON line with each
kernel's numbers, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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
    fa._lib()
    pl._lib()
    log("1-build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_kernel={k: round(v, 2) for k, v in
                    cuda_build.build_seconds.items()})


def phase_k1():
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(1)
    cases = [  # (name, dtype, B, N, bias batch or None)
        ("bf16_b4_n1025_shared", torch.bfloat16, 4, 1025, 1),
        ("bf16_b2_n1025_shared", torch.bfloat16, 2, 1025, 1),
        ("bf16_b1_n1793_shared", torch.bfloat16, 1, 1793, 1),
        ("f32_b2_n130_batched", torch.float32, 2, 130, 2),
        ("f32_b2_n130_none", torch.float32, 2, 130, None),
        ("f32_b2_n513_batched", torch.float32, 2, 513, 2),
        ("f32_b2_n513_none", torch.float32, 2, 513, None),
    ]
    worst = 0.0
    timed = None
    for name, dt, b, n, bb in cases:
        def mk(*shape):
            return torch.randn(*shape, generator=g).to("cuda", dt)
        q, k, v = mk(b, 16, n, 64), mk(b, 16, n, 64), mk(b, 16, n, 64)
        bias = mk(bb, 16, n, n) if bb else None
        got = fa.flash_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, bias)
        err = (got.float() - want.float()).abs().max().item()
        bound = K1_BOUND[str(dt).split(".")[-1]]
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, bias), 20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                           5)
        log("2-k1", case=name, max_abs_err=f"{err:.3e}", bound=bound,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
        if not err <= bound:
            raise AssertionError(f"K1 {name}: max abs err {err} > {bound}")
        worst = max(worst, err)
        if timed is None:
            timed = (ms, plain_ms)
    return worst, timed


def phase_k2():
    import torch
    from depthmap_tpu_torch.ops import polylines as pl
    g = torch.Generator(device="cpu").manual_seed(2)
    img = torch.randint(0, 256, (1080, 1920, 3), generator=g,
                        dtype=torch.uint8).cuda()
    nd = torch.rand((1080, 1920), generator=g, dtype=torch.float64).cuda()
    timed = []
    worst = 0
    for sharp in (True, False):
        for div in (24.0, -24.0, 48.0, -48.0):
            got = pl.polylines_cuda(img, nd, div, 0.0, 1.0, sharp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = pl.polylines_plain(img, nd, div, 0.0, 1.0, sharp)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ndiff = int((got != want).sum())
            worst = max(worst, int((got.int() - want.int()).abs().max()))
            ms = cuda_ms(lambda: pl.polylines_cuda(img, nd, div, 0.0, 1.0,
                                                   sharp), 3)
            log("3-k2", sharp=sharp, divergence_px=div, bytes_differ=ndiff,
                ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.1f}")
            if ndiff:
                raise AssertionError(f"K2 sharp={sharp} div={div}: {ndiff} "
                                     "bytes differ from the plain version")
            if sharp and abs(div) == 24.0:
                timed.append((ms, plain_ms))
    return worst, (sum(t[0] for t in timed) / len(timed),
                   sum(t[1] for t in timed) / len(timed))


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


def phase_main_path():
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

    fa.flash_attention_cuda.launches = 0
    pl.polylines_cuda.launches = 0
    results = {}
    t_start = time.perf_counter()
    t_batched = None
    for idx, typ, res in core_generation_funnel(None, images, None, None,
                                                inp, predictor_cache=cache):
        results[(idx, typ)] = res
        if idx == 3 and typ == "red-cyan-anaglyph":
            t_batched = time.perf_counter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    k1 = fa.flash_attention_cuda.launches
    k2 = pl.polylines_cuda.launches

    for i, img in enumerate(images):
        h, w = img.shape[:2]
        d = results[(i, "depth")]
        sbs = results[(i, "left-right")]
        ana = results[(i, "red-cyan-anaglyph")]
        assert d.dtype == np.uint16 and d.shape == (h, w), (i, d.shape)
        assert sbs.dtype == np.uint8 and sbs.shape == (h, 2 * w, 3)
        assert ana.dtype == np.uint8 and ana.shape == (h, w, 3)
        assert int(d.max()) - int(d.min()) > 0, f"image {i}: constant depth"
    forwards = 2   # one batched forward of the 4 512^2 images, one 1080p
    if k1 != blocks * forwards:
        raise AssertionError(f"K1 launched {k1} times, expected "
                             f"{blocks} x {forwards}")
    if k2 != 2 * len(images):
        raise AssertionError(f"K2 launched {k2} times, expected "
                             f"{2 * len(images)}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("4-main", model="dpt_beit_large_512", blocks=blocks, width=width,
        dtype=str(pred.compute_dtype), build_s=f"{build_s:.2f}",
        s_per_image_512_batched=f"{(t_batched - t_start) / 4:.4f}",
        s_per_image_1080p_serial=f"{t_end - t_batched:.4f}",
        k1_launches=k1, k2_launches=k2,
        max_memory_allocated_GiB=f"{peak_gib:.3f}")
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
    k1_err, (k1_ms, k1_plain_ms) = phase_k1()
    k2_err, (k2_ms, k2_plain_ms) = phase_k2()
    k1_launches, k2_launches = phase_main_path()
    phase_numerics()
    import torch
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": k1_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "polylines", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": k2_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
