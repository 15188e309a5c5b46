#!/usr/bin/env python3
"""Time Boost on dpt_beit_large_512 in one or more source trees, on one
CUDA card.

    python3 tools/boost_time.py [TREE ...]

Each tree (default: this checkout) runs in a process of its own, which
imports that tree's package: chip_smoke.py phase 13's textured 4:3 image
(768 x 1024, whole image at R_x 1536) through PredictorCache and
core_generation_funnel (boost, r_max 1600, a random pix2pix by
DEPTHMAP_ALLOW_RANDOM_PIX2PIX), a warm run, a timed run (s per image,
peak allocation, K1 launches), then torch.profiler over one more run
(this checkout's chip_smoke.profile_call: device ms by kernel, the
profiler's user-annotation ranges left out).  To compare two commits,
unpack both and give them as parent, change, change, parent.  The card's
name and power limit come first.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This checkout's chip_smoke.py (its image and profile helpers),
    whatever tree is timed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.environ["DEPTHMAP_ALLOW_RANDOM_PIX2PIX"] = "1"
    import torch
    from depthmap_tpu_torch.ops import flash_attention as fa
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline.core import (PredictorCache,
                                                  core_generation_funnel)
    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not {tree}'s package")
    sm = smoke()
    image = sm._textured(15, 768, 1024)
    inp = GenerationOptions(compute_device="GPU",
                            model_type="dpt_beit_large_512", boost=True)
    ops = {"boost_rmax": 1600}
    cache = PredictorCache()

    def run():
        return list(core_generation_funnel(None, [image], None, None, inp,
                                           ops, cache))
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sm.log("boost-time", tree=tree, s_per_image=f"{seconds:.3f}",
           R_x=cache._boost.last_run["whole_size"],
           k1_launches=fa.flash_attention_cuda.launches,
           k1_by_mode=getattr(fa.flash_attention_cuda, "launches_by_mode",
                              None),
           max_memory_allocated_GiB=
           f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    sm.profile_call(f"boost-time {tree}", run)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in sys.argv[1:] or [ROOT]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
