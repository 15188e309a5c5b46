#!/usr/bin/env python3
"""Where a Marigold image's host time goes, per source tree, on one CUDA
card.

    python3 tools/marigold_host_profile.py DTYPE [TREE ...]

DTYPE is float32 or bfloat16 (DEPTHMAP_MARIGOLD_DTYPE).  Each tree
(default: this checkout) runs in a process of its own, which builds that
tree's kernels and drives that tree's chip_smoke.py phase-14 Marigold run
(the full-width nets from seed 4, a 768 x 1024 image at res 768, ensemble
5, 12 steps: a warm image, then a timed one) under cProfile.  It prints the
phase's own line (s per image, K1 launches), the profile's total and its
top functions by own time, and the number of calls of the ensemble's
objective (``ensemble_depths``'s closure, which scipy's BFGS calls).  To
compare two commits, unpack both and give them as parent, change, change,
parent.  The card's name and power limit come first.
"""
from __future__ import annotations

import cProfile
import importlib.util
import io
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 12


def child(tree: str, dtype: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    from depthmap_tpu_torch.models.marigold.pipeline import build_marigold
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.ops import flash_attention as fa
    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not {tree}'s package")
    fa._lib()
    sd = init_random_(build_marigold(), seed=4).state_dict()
    image = sm._test_images(17, [(768, 1024)])[0]
    os.environ["DEPTHMAP_MARIGOLD_DTYPE"] = dtype
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    sm.drive_marigold(f"marigold-host {tree}", image, sd, False)
    prof.disable()
    print(f"[marigold-host] tree={tree} dtype={dtype} "
          f"profiled_s={time.perf_counter() - t0:.3f}", flush=True)
    stats = pstats.Stats(prof, stream=io.StringIO())
    closure = sum(v[1] for k, v in stats.stats.items()
                  if k[2] == "closure" and "marigold" in k[0])
    print(f"[marigold-host] tree={tree} ensemble_objective_calls={closure} "
          "(two images: warm and timed)", flush=True)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(TOP)
    print(out.getvalue(), flush=True)


def main() -> int:
    if len(sys.argv) > 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if len(sys.argv) < 2 or sys.argv[1] not in ("float32", "bfloat16"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in sys.argv[2:] or [ROOT]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree, sys.argv[1]], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
