"""device_idle_share: the share of the profiled stretch of whole jobs in
which no kernel, copy or memset ran on the card (torch.profiler)."""


def read(run):
    t = run.trace
    if t is None or t.seconds <= 0:
        return None
    return 100.0 * (1.0 - t.busy_seconds() / t.seconds)
