"""zoe_core_ms_per_image: the device time of the kernels launched inside
the program's ``zoe_core`` spans (one a forward: the BEiT DPT with its
taps), matched to their launches by the profiler's correlation ids
(``port_bench/span_kernels.py``), over the traced stretch's photos, in
ms."""
from port_bench import harness, span_kernels

NAME = "zoe_core"


def read(run):
    t = run.trace
    if t is None or t.photos == 0:
        return None
    events = span_kernels.read_events(harness.CHROME_TRACE)
    if not events:
        return None
    seconds, counts = span_kernels.device_seconds(events, (NAME,), t.start,
                                                  t.end)
    if counts[NAME] == 0:
        return None
    return 1000.0 * seconds[NAME] / t.photos
