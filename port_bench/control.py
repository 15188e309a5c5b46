"""The readings the check's limits are set from, on the card at a cell's
own size: for each seed, the program's numbers (its funnel on one job of
the cell's photos, against the f32 reference) and the control's (the
reference with every product's operands rounded to float8 e4m3, put in
the program's place, against the same f32 reference).

    python3 port_bench/control.py --workload CELL --seeds 11,12,13

One predictor serves every seed: each seed's weights are loaded into it
and its per-grid inputs (which it computes from the weights on the first
forward at a size) are dropped.  Prints one JSON line per seed and a
summary: the program's largest reading and the control's smallest.  Not
run by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import compare, harness, images, weights
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    bench = harness.Bench(cell, seeds[0], "cuda")
    bench.setup()
    rows = []
    for seed in seeds:
        t0 = time.time()
        bench.seed = seed
        weights.load(bench.predictor.bundle.module,
                     weights.make(bench.leaves, seed, "cuda"))
        bench.predictor._grid_inputs.clear()
        per_job = int(cell.traffic["photos_per_job"])
        n = max(per_job, int(cell.traffic["check"]["photos"]))
        imgs = images.photo_pool(cell.traffic["photo"], n, seed, "cuda")
        prog = []
        for j0 in range(0, n, per_job):   # jobs of the cell's size
            job = imgs[j0:j0 + per_job]
            maps = {}
            for idx, typ, res in bench.funnel(
                    None, job, None, None, bench.opts,
                    predictor_cache=bench.cache):
                if typ == "depth":
                    maps[idx] = res
            prog += [maps[i] for i in range(len(job))]
        ref = compare.reference_maps(cell, bench.leaves, seed, "cuda", imgs,
                                     "f32")
        ctl = compare.reference_maps(cell, bench.leaves, seed, "cuda", imgs,
                                     "fp8")
        rnd = compare.reference_maps(cell, bench.leaves, seed, "cuda", imgs,
                                     "bf16")
        photos = []
        for m, r, b, c in zip(prog, ref, rnd, ctl):
            photos.append({
                "live": compare.live_share(r),
                "fit": [compare.depth_numbers([x], [r], [b])
                        ["depth_fit_vs_bf16"] for x in (m, c)],
                "slope": [compare._fit_residual(x, r)[0] for x in (m, c)]})
        row = {"seed": seed,
               "program": compare.depth_numbers(prog, ref, rnd),
               "control": compare.depth_numbers(ctl, ref, rnd),
               "photos": photos,
               "seconds": round(time.time() - t0, 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["program"]:
        summary[name] = {
            "program_max": max(r["program"][name] for r in rows),
            "control_min": min(r["control"][name] for r in rows)}
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
