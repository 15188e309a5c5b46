#!/usr/bin/env python3
"""Time K2's sweep with and without its fast path, on one CUDA card.

    python3 tools/k2_sweep_paths.py

polylines_sweep (depthmap_tpu_torch/csrc/polylines.cu) has two forms of a
step's removal and best-segment choice: a fast one for 32 or fewer active
slots, all in registers, and a general one for any number of slots.  This
builds the source as it is and a copy in which the general form runs every
step, checks that both give the same bytes, and times each sweep on the
same sorted segments in the order source, general, general, source: at
1080x1920 and 512x512, sharp, on a random and a smooth depth map, at the
main path's divergence (+-2.5% / 2 of the width), the inputs of phase 3
of chip_smoke.py.  The card's name and power limit come first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_ms, k2_inputs  # noqa: E402

FAST_PATH = "if (n_active <= 32) {"
ITERS = 20


def build_general() -> ctypes.CDLL:
    """polylines.cu with the fast path switched off, built as the package
    builds the source."""
    from depthmap_tpu_torch.ops import cuda_build
    with open(os.path.join(cuda_build.CSRC, "polylines.cu")) as f:
        src = f.read()
    if src.count(FAST_PATH) != 1:
        raise RuntimeError(f"{FAST_PATH!r} is not in polylines.cu once")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(cuda_build.BUILD_DIR, "polylines_general.cu")
    with open(cu, "w") as f:
        f.write(src.replace(FAST_PATH, "if (false) {"))
    so = cu[:-3] + ".so"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS,
         *cuda_build.BASE_FLAGS, "-fmad=false", "-o", so, cu],
        capture_output=True, text=True, check=True)
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] lib=polylines_general {line.strip()}")
    return ctypes.CDLL(so)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from depthmap_tpu_torch.ops import cuda_build
    from depthmap_tpu_torch.ops import polylines as pl
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"source": pl._lib()}
    for line in cuda_build.build_logs.get("polylines", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] lib=polylines {line.strip()}")
    cuda_build._loaded["polylines"] = build_general()
    libs["general"] = pl._lib()   # gives the copy its argument types

    g = torch.Generator(device="cpu").manual_seed(2)
    for rows, w in ((1080, 1920), (512, 512)):
        img, maps = k2_inputs(g, rows, w)
        div = 0.0125 * w
        for depth, nd in maps.items():
            cuda_build._loaded["polylines"] = libs["source"]
            sorted_, rgb, order = pl._sort_cuda(img, nd, div, 0.0, 1.0, True)
            times = {"source": [], "general": []}
            want = None
            for name in ("source", "general", "general", "source"):
                cuda_build._loaded["polylines"] = libs[name]

                def sweep():
                    return pl._sweep_cuda(sorted_, rgb, order, w, 3, True)
                got = sweep()
                if want is None:
                    want = got
                elif not torch.equal(got, want):
                    raise AssertionError(f"{rows}x{w} {depth}: the general "
                                         "path's bytes differ")
                times[name].append(cuda_ms(sweep, ITERS))
            src = sum(times["source"]) / 2
            gen = sum(times["general"]) / 2
            print(f"[k2-sweep] shape={rows}x{w} depth={depth} "
                  f"divergence_px={div} source_ms={times['source']} "
                  f"general_ms={times['general']} source_mean={src:.4f} "
                  f"general_mean={gen:.4f} general_over_source="
                  f"{gen / src:.3f}", flush=True)
    cuda_build._loaded["polylines"] = libs["source"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
