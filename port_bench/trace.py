"""What a profiled stretch of whole jobs says: the device's kernels and
copies, the host's spans, busy time, idle gaps and launch counts.

The stretch is read from torch.profiler's Chrome trace (CPU and CUDA
activity): device events are those of categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; host spans are ``user_annotation``
events (the harness's ``job`` spans and the program's ``stage`` spans).
The stretch runs from the first ``job`` span's start to the last one's
end.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Event = Tuple[str, float, float]   # name, start (us), duration (us)


@dataclass
class Stretch:
    kernels: List[Event]
    copies: List[Event]          # memcpy and memset
    spans: List[Event]           # host annotations
    start: float                 # us
    end: float
    photos: int = 0
    forwards: List[int] = field(default_factory=list)   # batch sizes
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def device_events(self) -> List[Event]:
        return self.kernels + self.copies

    def busy_seconds(self) -> float:
        """The union of the device events' intervals inside the stretch."""
        spans = sorted((max(s, self.start), min(s + d, self.end))
                       for _, s, d in self.device_events())
        busy, cur0, cur1 = 0.0, None, None
        for s, e in spans:
            if e <= s:
                continue
            if cur1 is None or s > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                cur0, cur1 = s, e
            else:
                cur1 = max(cur1, e)
        if cur1 is not None:
            busy += cur1 - cur0
        return busy / 1e6

    def seconds_of(self, names) -> float:
        """Device seconds of the kernels whose name holds any of
        ``names``."""
        return sum(d for n, _, d in self.kernels
                   if any(k in n for k in names)) / 1e6

    def count_of(self, names) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if any(k in n for k in names))

    def top_ops(self, limit: int = 10) -> List[list]:
        """The device operations (kernels and copies by name) with the
        most time, [name, seconds]."""
        total: Dict[str, float] = {}
        for n, _, d in self.device_events():
            total[n] = total.get(n, 0.0) + d / 1e6
        return [[n[:120], t] for n, t in
                sorted(total.items(), key=lambda kv: -kv[1])[:limit]]

    def idle_gaps(self, limit: int = 10) -> List[list]:
        """The longest stretches with nothing on the device, each named
        by the innermost host span open at its middle, [name, seconds]."""
        ev = sorted((s, s + d) for _, s, d in self.device_events())
        gaps, t = [], self.start
        for s, e in ev:
            if s > t:
                gaps.append((t, min(s, self.end)))
            t = max(t, e)
        if t < self.end:
            gaps.append((t, self.end))
        out = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:limit]:
            mid = 0.5 * (g0 + g1)
            open_ = [(d, n) for n, s, d in self.spans if s <= mid <= s + d]
            out.append([min(open_)[1] if open_ else "outside a span",
                        (g1 - g0) / 1e6])
        return out


def read_chrome_trace(path: str) -> Stretch:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, copies, spans = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        if cat == "kernel":
            kernels.append(item)
        elif cat in DEVICE_CATS:
            copies.append(item)
        elif cat == "user_annotation":
            spans.append(item)
    jobs = [(s, s + d) for n, s, d in spans if n == "job"]
    if not jobs:
        raise ValueError(f"{path}: no job span in the trace")
    start, end = min(j[0] for j in jobs), max(j[1] for j in jobs)

    def inside(items):
        return [i for i in items if i[1] < end and i[1] + i[2] > start]
    return Stretch(inside(kernels), inside(copies), inside(spans), start,
                   end)
