#!/usr/bin/env python3
"""Time K2 (polylines_cuda) of the port in one or more source trees, on one
CUDA card.

    python3 tools/k2_time.py [TREE ...]

Each tree (default: this checkout) runs in a process of its own, which
builds that tree's kernels and times its polylines_cuda on the inputs of
phase 3 of chip_smoke.py: 1080x1920 and 512x512, sharp, random and smooth
depth, at the main path's divergence (+-2.5% / 2 of the width).  Per case
it prints the time per call as a caller sees it (CUDA events over calls
issued back to back), each kernel's device time per call (torch.profiler),
the device memory one call allocates at its peak and, where the tree's
sweep counts them, its parts, replayed parts and whole rows on one call.
To compare two commits, unpack both and give them as parent, change,
change, parent.  The card's name and power limit come first.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 20


def smoke():
    """This checkout's chip_smoke.py (its phase-3 inputs), whatever tree
    is timed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from depthmap_tpu_torch.ops import polylines as pl
    if not pl.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pl.__file__}, not {tree}'s package")
    pl._lib()
    k2_inputs = smoke().k2_inputs
    g = torch.Generator(device="cpu").manual_seed(2)
    for rows, w in ((1080, 1920), (512, 512)):
        img, maps = k2_inputs(g, rows, w)
        div = 0.0125 * w
        for depth, nd in maps.items():
            def k2():
                return pl.polylines_cuda(img, nd, div, 0.0, 1.0, True)
            k2()
            counts = None   # a tree whose sweep counts its replays
            if hasattr(pl, "replay_counts"):
                pl.reset_replay_counts()
                k2()
                counts = pl.replay_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            k2()
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                k2()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / ITERS
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    k2()
                torch.cuda.synchronize()
            dev = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and "polylines" in e.key:
                    t = getattr(e, "self_device_time_total", None)
                    if t is None:
                        t = e.self_cuda_time_total
                    name = re.search(r"polylines_\w+", e.key).group(0)
                    dev[name] = round(t / 1e3 / ITERS, 4)
            print("[k2-time] " + json.dumps({
                "tree": tree, "shape": f"{rows}x{w}", "depth": depth,
                "divergence_px": div, "ms_per_call": round(ms, 4),
                "device_ms_per_call": dev,
                "peak_alloc_MB": round(peak_mb, 1),
                "sweep_counts": counts}), flush=True)


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
    trees = sys.argv[1:] or [ROOT]
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
