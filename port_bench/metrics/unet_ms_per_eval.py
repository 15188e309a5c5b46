"""unet_ms_per_eval: the device time of the kernels launched inside the
program's ``marigold_unet`` spans (one a UNet evaluation), matched to
their launches by the profiler's correlation ids
(``port_bench/span_kernels.py``), over the number of those spans in the
traced stretch, in ms."""
from port_bench import harness, span_kernels

NAME = "marigold_unet"


def read(run):
    t = run.trace
    if t is None:
        return None
    events = span_kernels.read_events(harness.CHROME_TRACE)
    if not events:
        return None
    seconds, counts = span_kernels.device_seconds(events, (NAME,), t.start,
                                                  t.end)
    if counts[NAME] == 0:
        return None
    return 1000.0 * seconds[NAME] / counts[NAME]
