"""vae_ms_per_image: the device time of the kernels launched inside the
program's ``marigold_encode`` and ``marigold_decode`` spans, matched to
their launches by the profiler's correlation ids
(``port_bench/span_kernels.py``), over the traced stretch's photos, in
ms."""
from port_bench import harness, span_kernels

NAMES = ("marigold_encode", "marigold_decode")


def read(run):
    t = run.trace
    if t is None or t.photos == 0:
        return None
    events = span_kernels.read_events(harness.CHROME_TRACE)
    if not events:
        return None
    seconds, counts = span_kernels.device_seconds(events, NAMES, t.start,
                                                  t.end)
    if not any(counts.values()):
        return None
    return 1000.0 * sum(seconds.values()) / t.photos
