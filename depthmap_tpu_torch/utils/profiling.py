"""Per-stage wall-clock spans and torch.profiler traces.

Port of ``depthmap_tpu/utils/profiling.py``: ``stage``, ``timings``,
``report``, ``enable`` and ``reset`` behave as there.  ``stage`` also opens
a ``torch.profiler.record_function`` of the same name, so a span shows in
a profiler trace (``chip_smoke.py --profile``) beside the kernels it ran;
``trace(logdir)`` runs torch.profiler (CPU, and CUDA where present) and
writes a Chrome trace into ``logdir``.

    from depthmap_tpu_torch.utils.profiling import stage, report
    with stage("depth_predict"):
        ...
    print(report())

    with trace("/tmp/torch-trace"):      # trace.json for chrome://tracing
        ...
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

_TIMINGS: Dict[str, list] = defaultdict(list)
_ENABLED = True


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


def reset() -> None:
    _TIMINGS.clear()


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    if not _ENABLED:
        yield
        return
    from torch.profiler import record_function
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        _TIMINGS[name].append(time.perf_counter() - t0)


def timings() -> Dict[str, list]:
    return dict(_TIMINGS)


def report() -> str:
    lines = ["stage                      calls   total(s)   mean(ms)"]
    for name, ts in sorted(_TIMINGS.items(), key=lambda kv: -sum(kv[1])):
        lines.append(f"{name:<26} {len(ts):>5}   {sum(ts):8.3f}   "
                     f"{1000 * sum(ts) / len(ts):8.2f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """torch.profiler over the block; writes ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
