"""The readings the ZoeDepth K cell's limit is set from, on the card at
the cell's own size: for each seed, the program's numbers (its funnel on
one job of the cell's photos, against the f32 reference) and, each put in
the program's place against the same f32 reference, the reference with
its core rounded to bf16 (as the check's bf16 side) under a head that
breaks the configuration's precision:

- ``head_round``: every product's operands of the head rounded to bf16;
- ``head_bf16``: the head computed in bf16, as a half model runs it (its
  weights, the taps and every tensor it makes in bf16);
- ``head_tf32``: the head in f32 with cuDNN's TF32 convolutions on;

and ``fp8``, the whole reference with every product's operands rounded to
float8 e4m3 (``port_bench/control.py``'s control).

    python3 port_bench/control_zoedepth.py --seeds 11,12,13

The core runs once a photo for the four bf16-core maps (its taps are
kept while the head runs each way).  Prints one JSON line per seed and a
summary: the program's largest reading and each control's smallest.  Not
run by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROLS = ("head_round", "head_bf16", "head_tf32", "fp8")


class _KeptTaps:
    """A core's ``taps`` that computes once and then hands back what it
    computed (cast to ``dtype`` where one is set), until ``clear``."""

    def __init__(self, taps):
        self.taps, self.out, self.dtype = taps, None, None

    def clear(self):
        self.out = None

    def __call__(self, x):
        if self.out is None:
            self.out = self.taps(x)
        if self.dtype is None:
            return self.out
        rel, act, btlnck, blocks = self.out
        return (rel.to(self.dtype), act.to(self.dtype),
                btlnck.to(self.dtype), [b.to(self.dtype) for b in blocks])


def _tf32_numerics():
    import torch
    from port_bench.reference import common

    class TF32(common.Numerics):
        """f32 operands, convolved with cuDNN's TF32 on."""

        def conv(self, x, w, b=None, stride=1, padding=0):
            torch.backends.cudnn.allow_tf32 = True
            try:
                return super().conv(x, w, b, stride, padding)
            finally:
                torch.backends.cudnn.allow_tf32 = False
    return TF32("f32")


def reference_maps(cell, leaves, seed: int, photos, device="cuda"):
    """{"f32", "bf16", *CONTROLS} -> the reference's uint16 map of each
    photo, computed as the name says."""
    import torch
    from port_bench import weights
    from port_bench.harness import net_size
    from port_bench.reference import common, zoedepth
    common.f32_matmuls()
    w = weights.make(leaves, seed, device, dtype=torch.float32)
    f32 = zoedepth.build(cell.config, w, common.Numerics("f32"))
    fp8 = zoedepth.build(cell.config, w, common.Numerics("fp8"))
    bf16 = zoedepth.build(cell.config, w, common.Numerics("bf16"))
    kept = bf16.core.taps = _KeptTaps(bf16.core.taps)
    head_w = bf16.w
    head_w_bf16 = {k: v.to(torch.bfloat16) for k, v in head_w.items()}
    heads = {"bf16": (common.Numerics("f32"), head_w, None),
             "head_round": (common.Numerics("bf16"), head_w, None),
             "head_bf16": (common.Numerics("f32"), head_w_bf16,
                           torch.bfloat16),
             "head_tf32": (_tf32_numerics(), head_w, None)}
    out = {k: [] for k in ("f32", "bf16") + CONTROLS}
    for img in photos:
        h, wd = img.shape[:2]
        nw, nh = net_size(cell, wd, h)
        net_hw = common.net_input_size(cell.config, wd, h, nw, nh)
        keep = cell.config["predicts_depth"]
        for name, model in (("f32", f32), ("fp8", fp8)):
            out[name].append(common.to_uint16(model.raw(img, net_hw), keep))
        kept.clear()
        for name, (hx, hw, dtype) in heads.items():
            bf16.hx, bf16.w, kept.dtype = hx, hw, dtype
            out[name].append(common.to_uint16(bf16.raw(img, net_hw), keep))
    del f32, fp8, bf16, kept, w, head_w_bf16
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="zoedepth_k-photos")
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
        n = int(cell.traffic["photos_per_job"])
        imgs = images.photo_pool(cell.traffic["photo"], n, seed, "cuda")
        maps = {}
        for idx, typ, res in bench.funnel(None, imgs, None, None,
                                          bench.opts,
                                          predictor_cache=bench.cache):
            if typ == "depth":
                maps[idx] = res
        prog = [maps[i] for i in range(n)]
        ref = reference_maps(cell, bench.leaves, seed, imgs)
        row = {"seed": seed,
               "program": compare.depth_numbers(prog, ref["f32"],
                                                ref["bf16"])}
        for name in CONTROLS:
            row[name] = compare.depth_numbers(ref[name], ref["f32"],
                                              ref["bf16"])
        row["photos"] = [
            {"live": compare.live_share(r),
             "fit": {name: compare.depth_numbers([x], [r], [b])
                     ["depth_fit_vs_bf16"] for name, x in
                     zip(("program",) + CONTROLS,
                         [p] + [ref[c][i] for c in CONTROLS])}}
            for i, (p, r, b) in enumerate(zip(prog, ref["f32"],
                                              ref["bf16"]))]
        row["seconds"] = round(time.time() - t0, 2)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["program"]:
        summary[name] = {"program_max": max(r["program"][name]
                                            for r in rows)}
        for c in CONTROLS:
            summary[name][f"{c}_min"] = min(r[c][name] for r in rows)
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
