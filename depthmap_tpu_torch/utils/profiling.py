"""Per-stage wall-clock spans: timings, records and profiler ranges.

Port of ``depthmap_tpu/utils/profiling.py``: ``stage``, ``timings``,
``report``, ``enable`` and ``reset`` behave as there.  Beyond it:

- Each span also leaves a record (``spans()``, a ``Span``): its name, its
  start and end on ``time.perf_counter_ns()``, its number in the order
  spans opened (``id``), the number of the span open around it on the
  same thread (``parent``, -1 at the top) and the call it belongs to
  (``call``: ``core_generation_funnel`` takes one from ``new_call()`` per
  call and passes it to its own spans; a span given none takes its
  parent's, or -1).  The last ``MAX_RECORDS`` records are kept; older
  ones are dropped and counted (``dropped()``).
- While a torch profiler runs, a span is also a
  ``torch.profiler.record_function`` range of the same name, so it shows
  in the trace as a ``user_annotation`` on the clock of the device's
  events.  Without a profiler it enters no range: two clock reads and two
  appends.
- ``report()`` gives each name's calls, total, mean and self time (its
  total less the time its child spans cover).

    from depthmap_tpu_torch.utils.profiling import stage, report
    with stage("depth_batch"):
        ...
    print(report())
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

MAX_RECORDS = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int


_TIMINGS: Dict[str, list] = defaultdict(list)
_SELF_NS: Dict[str, int] = defaultdict(int)
_RECORDS: deque = deque(maxlen=MAX_RECORDS)
_DROPPED = 0
_ENABLED = True
_IDS = itertools.count()
_CALLS = itertools.count()
_LOCK = threading.Lock()
_OPEN = threading.local()      # .stack: the thread's open spans
_profiler_enabled = torch._C._autograd._profiler_enabled


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


def reset() -> None:
    global _DROPPED
    with _LOCK:
        _TIMINGS.clear()
        _SELF_NS.clear()
        _RECORDS.clear()
        _DROPPED = 0


def new_call() -> int:
    """A fresh call identifier for the spans of one funnel call."""
    return next(_CALLS)


class _Stage:
    __slots__ = ("name", "call", "id", "parent", "child_ns", "t0",
                 "_range", "_stack")

    def __init__(self, name: str, call: Optional[int]):
        self.name = name
        self.call = call
        self._stack = None

    def __enter__(self) -> "_Stage":
        if not _ENABLED:
            return self
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        if self.call is None:
            self.call = -1 if self.parent is None else self.parent.call
        self.id = next(_IDS)
        self.child_ns = 0
        self._range = record_function(self.name) \
            if _profiler_enabled() else None
        if self._range is not None:
            self._range.__enter__()
        stack.append(self)
        self._stack = stack
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _DROPPED
        t1 = time.perf_counter_ns()
        stack = self._stack
        if stack is None:
            return False
        stack.pop()
        ns = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        record = (self.name, self.t0, t1, self.id,
                  -1 if parent is None else parent.id, self.call)
        with _LOCK:
            _TIMINGS[self.name].append(ns / 1e9)
            _SELF_NS[self.name] += ns - self.child_ns
            if len(_RECORDS) == MAX_RECORDS:
                _DROPPED += 1
            _RECORDS.append(record)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def stage(name: str, call: Optional[int] = None) -> _Stage:
    """``with stage(name):`` times the block as one span (``call``: the
    funnel call's identifier, else the parent span's)."""
    return _Stage(name, call)


def timings() -> Dict[str, list]:
    """Name -> the durations (s) of its spans, in the order they closed."""
    return dict(_TIMINGS)


def spans() -> List[Span]:
    """The kept records, in the order the spans opened."""
    with _LOCK:
        return [Span(*r) for r in sorted(_RECORDS, key=lambda r: r[3])]


def dropped() -> int:
    """Records dropped since the last ``reset()`` to keep ``MAX_RECORDS``."""
    return _DROPPED


def report() -> str:
    lines = ["stage                      calls   total(s)   mean(ms)    "
             "self(s)"]
    for name, ts in sorted(_TIMINGS.items(), key=lambda kv: -sum(kv[1])):
        lines.append(f"{name:<26} {len(ts):>5}   {sum(ts):8.3f}   "
                     f"{1000 * sum(ts) / len(ts):8.2f}   "
                     f"{_SELF_NS[name] / 1e9:8.3f}")
    return "\n".join(lines)
