"""Device time of the kernels that the host launched inside named spans.

The host runs ahead of the card, so a kernel often runs after the span
that launched it has closed, and matching by time overlap would charge it
to whatever span is open then.  torch.profiler's Chrome trace ties each
kernel to its launch by a correlation id (``args.correlation`` on the
``kernel`` event and on the ``cuda_runtime`` or ``cuda_driver`` launch
event): a kernel counts for a span when its launch lies inside the span
on the same thread.  Only spans inside the traced stretch count.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def read_events(path: str) -> Optional[list]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def device_seconds(events: list, names: Iterable[str], start: float,
                   end: float) -> Tuple[Dict[str, float], Dict[str, int]]:
    """({span name: device seconds of the kernels launched inside spans of
    that name}, {span name: number of such spans}) for the spans named
    ``names`` that lie inside [start, end] (trace microseconds)."""
    names = tuple(names)
    spans = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                e.get("name") in names and "dur" in e:
            s = float(e["ts"])
            if s >= start and s + float(e["dur"]) <= end:
                spans.append((s, s + float(e["dur"]), e.get("tid"),
                              e["name"]))
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
    seconds = dict.fromkeys(names, 0.0)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        at = launch.get((e.get("args") or {}).get("correlation"))
        if at is None:
            continue
        ts, tid = at
        for s0, s1, stid, name in spans:
            if s0 <= ts <= s1 and stid == tid:
                seconds[name] += float(e["dur"]) / 1e6
                break
    counts = {n: sum(1 for s in spans if s[3] == n) for n in names}
    return seconds, counts
