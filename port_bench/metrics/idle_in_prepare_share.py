"""idle_in_prepare_share: the share of the profiled stretch of whole jobs
in which nothing runs on the card (no kernel, copy or memset) while the
innermost open host span is the funnel's ``prepare`` (utils/profiling.py),
on the trace's own clock.  The innermost open span is the shortest one,
as the stretch's idle gaps are named."""

NAME = "prepare"


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _minus(intervals, holes):
    """The merged ``intervals`` less the merged ``holes``."""
    out, j = [], 0
    for s, e in intervals:
        while j < len(holes) and holes[j][1] <= s:
            j += 1
        k, t = j, s
        while k < len(holes) and holes[k][0] < e:
            if holes[k][0] > t:
                out.append([t, holes[k][0]])
            t = max(t, holes[k][1])
            k += 1
        if t < e:
            out.append([t, e])
    return out


def read(run):
    t = run.trace
    if t is None or t.seconds <= 0:
        return None
    named = [(s, s + d) for n, s, d in t.spans if n == NAME]
    if not named:
        return None
    # where a span opens inside a prepare span and closes before it ends,
    # that span is the innermost one
    nested = [(s, s + d) for n, s, d in t.spans for p0, p1 in named
              if p0 <= s and s + d <= p1 and (s, s + d) != (p0, p1)]
    innermost = _minus(_merged(
        (max(s, t.start), min(e, t.end)) for s, e in named),
        _merged(nested))
    busy = _merged((max(s, t.start), min(s + d, t.end))
                   for _, s, d in t.device_events())
    idle = sum(e - s for s, e in _minus(innermost, busy))
    return 100.0 * idle / (t.end - t.start)
