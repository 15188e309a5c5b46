"""One run of one cell: set-up, the measured window, the traced stretch and
the check of what the window produced.

A cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``configs/<name>.json``, its work count ``configs/<name>_work.py``, its
plain reference ``reference/<family>.py``) under a traffic mix
(``traffic/<name>.json``).  Every metric is read by
``metrics/<name>.py``; the limits of the check are in
``limits/<cell>.json``.  Nothing here names a cell, a configuration or a
metric: a later cell is data.

The window drives the program's user path, ``core_generation_funnel``
with one ``PredictorCache``, in a closed loop: a job is one funnel call on
the job's photos, the next sent when the last output of the previous one
is yielded.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules that may not be loaded in the process that prints a
# result: JAX and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "depthmap_tpu")
CHROME_TRACE = os.path.join(ROOT, "port_bench_out", "trace.json")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """Import the module at ``path`` (a reader, a work count)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``depthmap_tpu_torch`` is not ``depthmap_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    bench: dict

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def work(self):
        return load_file(os.path.join(
            BENCH_DIR, "configs", f"{self.config['name']}_work.py"),
            f"port_bench_work_{self.config['name']}")

    def reference(self):
        return importlib.import_module(
            f"port_bench.reference.{self.config['reference']}")

    def limits(self) -> dict:
        return load_json(os.path.join(BENCH_DIR, "limits",
                                      f"{self.name}.json"))

    def metrics(self, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: those that list it, or list no cells."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     f"{wl['traffic']}.json"))
    return Cell(name, wl, config, traffic, bench)


def net_size(cell: Cell, w: int, h: int):
    """(net_w, net_h) the user asks for: the model's default (what the UI
    sets on a model change), the funnel's ``net_size_match`` (each side
    rounded up to a multiple of 32), or a fixed pair."""
    net = cell.traffic.get("net", "default")
    if net == "match":
        return (w + 31) // 32 * 32, (h + 31) // 32 * 32
    if net == "default":
        return tuple(cell.config["default_net_size"])
    return tuple(net)


def funnel_options(cell: Cell, compute_device: str) -> dict:
    photo = cell.traffic["photo"]
    nw, nh = net_size(cell, photo["width"], photo["height"])
    opts = dict(cell.traffic.get("options", {}))
    opts.update(model_type=cell.config["model_type"],
                compute_device=compute_device, net_width=nw, net_height=nh,
                net_size_match=cell.traffic.get("net") == "match")
    return opts


def expected_outputs(opts: dict) -> List[str]:
    out = ["depth"] if opts.get("do_output_depth", True) else []
    if opts.get("gen_stereo"):
        out += list(opts["stereo_modes"])
    return out


@dataclass
class Window:
    jobs: int = 0
    photos: int = 0
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    job_s: List[float] = field(default_factory=list)
    peak_bytes: Optional[int] = None
    spans: Dict[str, list] = field(default_factory=dict)


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    setup_s: float
    window: Window
    work: Any
    net_hw: tuple
    peaks: Optional[dict]
    trace: Any = None       # trace.Stretch of the traced run


class Bench:
    """One run of a cell on ``device`` ("cuda", or "cpu" for the tests'
    drive of everything but the card)."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 t0: Optional[float] = None):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.t0 = time.time() if t0 is None else t0
        self.forwards: List[tuple] = []
        self.kept: List[dict] = []       # the sample the check compares
        self.seen = 0
        self.rng = np.random.default_rng(self.seed % (1 << 64))
        self.problems: List[str] = []

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        import torch
        from port_bench import images, weights
        from depthmap_tpu_torch.ops import cuda_build
        from depthmap_tpu_torch.pipeline.core import (
            PredictorCache, core_generation_funnel, options_device)
        from depthmap_tpu_torch.options import GenerationOptions
        from port_bench.reference.common import net_input_size
        self.torch = torch
        self.funnel = core_generation_funnel
        cell = self.cell
        t = {"imports": time.time()}
        photo = cell.traffic["photo"]
        self.pool = images.photo_pool(photo, int(cell.traffic["pool"]),
                                      self.seed, self.device)
        t["inputs"] = time.time()
        self.opts = funnel_options(
            cell, "GPU" if self.device == "cuda" else "CPU")
        inp = GenerationOptions.from_dict(self.opts)
        self.cache = PredictorCache()
        self.predictor = self.cache.get(inp.model_type,
                                        tiling_mode=inp.tiling_mode,
                                        device=options_device(inp))
        t["predictor"] = time.time()
        module = self.predictor.bundle.module
        self.leaves = weights.plan(
            module, cell.config.get("positive_weights", ()))
        weights.load(module, weights.make(self.leaves, self.seed,
                                          self.device))
        t["weights"] = time.time()
        module.register_forward_hook(self._count_forward)
        nw, nh = net_size(cell, photo["width"], photo["height"])
        self.net_hw = net_input_size(cell.config, photo["width"],
                                     photo["height"], nw, nh)
        self.job(0)
        seen = {fw[1] for fw in self.forwards}
        if seen != {tuple(self.net_hw)}:
            raise ValueError(f"the net input was {seen}; the benchmark "
                             f"counts the work of {self.net_hw}")
        self.sync()
        t["warmup"] = time.time()
        self.setup_s = t["warmup"] - self.t0
        steps = ["imports", "inputs", "predictor", "weights", "warmup"]
        prev = self.t0
        split = {}
        for s in steps:
            split[s] = round(t[s] - prev, 4)
            prev = t[s]
        log("setup", json.dumps(split), "kernel_build_s",
            json.dumps({k: round(v, 4)
                        for k, v in cuda_build.build_seconds.items()}))

    def _count_forward(self, module, args, output) -> None:
        x = args[0]
        self.forwards.append((int(x.shape[0]), tuple(x.shape[2:])))

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    # -- jobs --------------------------------------------------------------
    def job_images(self, j: int) -> List[np.ndarray]:
        n = int(self.cell.traffic["photos_per_job"])
        return [self.pool[(j * n + i) % len(self.pool)] for i in range(n)]

    def job(self, j: int, window: Optional[Window] = None) -> None:
        """Run job ``j``; inside the window, count it and keep its photos
        for the sample."""
        imgs = self.job_images(j)
        want = expected_outputs(self.opts)
        got: Dict[int, dict] = {i: {} for i in range(len(imgs))}
        t0 = time.perf_counter()
        t1 = t0
        ok = True
        try:
            for idx, typ, res in self.funnel(
                    None, imgs, None, None, self.opts,
                    predictor_cache=self.cache):
                got[idx][typ] = res
                t1 = time.perf_counter()
        except Exception:
            ok = False
            self.problems.append(f"job {j}: {traceback.format_exc()}")
            log(self.problems[-1])
        if window is None:
            return
        done = [i for i in got if ok and all(k in got[i] for k in want)]
        window.jobs += 1
        window.attempted += len(imgs)
        window.failed += len(imgs) - len(done)
        window.photos += len(done)
        window.job_s.append(t1 - t0)
        for i in done:
            self._reservoir({"image": imgs[i], "outputs": got[i]})

    def _reservoir(self, item: dict) -> None:
        """Keep a uniform sample, drawn from the seed, of the photos the
        window finished."""
        cap = int(self.cell.traffic["check"]["photos"])
        if len(self.kept) < cap:
            self.kept.append(item)
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < cap:
                self.kept[r] = item
        self.seen += 1

    def launches(self) -> Dict[str, int]:
        from depthmap_tpu_torch.ops import flash_attention as fa
        from depthmap_tpu_torch.ops import polylines as pl
        return {"k1": int(fa.flash_attention_cuda.launches),
                "k2_sort": int(pl._sort_cuda.launches),
                "k2_sweep": int(pl._sweep_cuda.launches)}

    def window(self, seconds: float) -> Window:
        from depthmap_tpu_torch.utils import profiling
        win = Window()
        torch = self.torch
        self.sync()
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        self.forwards.clear()
        before = self.launches()
        start = time.perf_counter()
        j = 1
        while True:
            self.job(j, window=win)
            j += 1
            if time.perf_counter() - start >= seconds:
                break
        self.sync()
        win.seconds = time.perf_counter() - start
        if self.device == "cuda":
            win.peak_bytes = int(torch.cuda.max_memory_allocated())
        win.spans = profiling.timings()
        self.next_job = j
        self._check_launches(before, self.forwards, "window")
        return win

    def _check_launches(self, before, forwards, where) -> Dict[str, int]:
        """K1 once per block and forward; K2's sort and sweep once per eye
        (two a photo when stereo is on).  Counted on the card only (the
        CPU runs the kernels' plain versions)."""
        ran = {k: v - before[k] for k, v in self.launches().items()}
        if self.device != "cuda":
            return ran
        blocks = int(self.cell.config["num_hidden_layers"])
        photos = sum(b for b, _ in forwards)
        eyes = 2 * photos if self.opts.get("gen_stereo") else 0
        want = {"k1": blocks * len(forwards), "k2_sort": eyes,
                "k2_sweep": eyes}
        if ran != want:
            self.problems.append(f"{where}: launches {ran}, expected {want}"
                                 f" ({len(forwards)} forwards of {photos} "
                                 "photos)")
            log(self.problems[-1])
        return ran

    # -- the traced stretch -------------------------------------------------
    def traced(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        from port_bench import trace
        torch = self.torch
        jobs = int(self.cell.traffic["trace_jobs"])
        self.sync()
        self.forwards.clear()
        before = self.launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(jobs):
                with record_function("job"):
                    self.job(self.next_job + k)
            torch.cuda.synchronize()
        ran = self._check_launches(before, self.forwards, "traced stretch")
        os.makedirs(os.path.dirname(CHROME_TRACE), exist_ok=True)
        prof.export_chrome_trace(CHROME_TRACE)
        stretch = trace.read_chrome_trace(CHROME_TRACE)
        stretch.forwards = [b for b, _ in self.forwards]
        stretch.photos = sum(stretch.forwards)
        stretch.launches = ran
        seen = {"k1": stretch.count_of(("flash_fwd",)),
                "k2_sort": stretch.count_of(("polylines_sort",)),
                "k2_sweep": stretch.count_of(("polylines_sweep",))}
        if seen != ran:
            raise RuntimeError(f"the profile saw the launches {seen} of "
                               f"{ran}: no kernel metric is read from it")
        return stretch

    # -- the check ------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        if self.cache._predictor is not self.predictor:
            self.problems.append("the predictor was rebuilt in the window")
        self.cache.release()
        self.predictor = None
        gc.collect()
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def check(self) -> Dict[str, dict]:
        """Compare the kept sample with the plain reference: each number
        beside its limit."""
        from port_bench import compare
        return compare.check(self)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def read_metrics(run: Run, wanted: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in wanted:
        reader = load_file(os.path.join(BENCH_DIR, "metrics",
                                        f"{m['name']}.py"),
                           f"port_bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: Optional[float] = None) -> dict:
    """Set up, measure, trace, check: the result's object."""
    from port_bench import peaks
    bench = Bench(cell, seed, device, t0)
    bench.setup()
    t = time.time()
    win = bench.window(seconds)
    q = np.percentile(win.job_s, [5, 50, 95]) if win.job_s else []
    log(f"window {win.seconds:.3f} s, {win.jobs} jobs; job s p5 / p50 / "
        f"p95 {' / '.join(f'{x:.4f}' for x in q)}")
    torch = bench.torch
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    run = Run(cell, bench.setup_s, win, cell.work(), bench.net_hw,
              peaks.for_card(kind))
    if traced:
        t = time.time()
        run.trace = bench.traced()
        log(f"traced stretch and its reading {time.time() - t:.3f} s")
    bench.release()
    t = time.time()
    checks = bench.check()
    log(f"check {time.time() - t:.3f} s")
    checks["photos_failed"] = {"value": float(win.failed), "limit": 0.0}
    checks["problems"] = {"value": float(len(bench.problems)), "limit": 0.0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct),
              "attempted": win.attempted, "failed": win.failed,
              "metrics": read_metrics(run, cell.metrics(traced)),
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": win.peak_bytes}}
    if traced:
        result["device"]["busy_s"] = run.trace.busy_seconds()
        result["device"]["window_s"] = run.trace.seconds
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    for p in bench.problems:
        log("problem:", p.splitlines()[0])
    result["checks"] = checks
    return result
