"""CPU tests of the readers of the program's spans: the window's summed
`prepare` / `download` seconds per photo, and the card's idle share under
the innermost `prepare` span of the traced stretch; each reads None where
the program records no such span."""
from __future__ import annotations

import os

import pytest

from port_bench import harness, trace
from port_bench.tests import tiny


def reader(name):
    return harness.load_file(os.path.join(tiny.BENCH_DIR, "metrics",
                                          f"{name}.py"), f"r_{name}")


def span_run(spans, stretch=None):
    win = harness.Window(jobs=2, photos=16, attempted=16, seconds=2.0,
                         job_s=[1.0, 1.0], spans=spans)
    cell = harness.load_cell("beit512-1080p-stereo")
    return harness.Run(cell, 12.5, win, cell.work(), (512, 896), None,
                       stretch)


@pytest.mark.parametrize("name,span,want", [
    ("host_prep_ms_per_image", "prepare", 10.0),
    ("depth_wait_ms_per_image", "download", 12.5),
])
def test_window_span_readers(name, span, want):
    """The window's summed span seconds over its photos, in ms; None
    where the program records no such span."""
    durations = {"prepare": [0.1, 0.06], "download": [0.15, 0.05]}
    run = span_run({span: durations[span], "stereo": [0.5]})
    assert reader(name).read(run) == pytest.approx(want)
    assert reader(name).read(span_run({"stereo": [0.5]})) is None


def test_idle_in_prepare_share():
    """A job span (0-100 us), a prepare span (10-40) over a device gap, and
    a kernel (30-50): the card idles 10-30 inside prepare, 20% of the
    stretch; the gaps under the job alone (0-10, 50-100) count nothing.
    A span nested in prepare (15-20) is the innermost there; no prepare
    span, or no trace, reads None."""
    read = reader("idle_in_prepare_share").read

    def stretch(spans):
        return trace.Stretch([("k", 30.0, 20.0)], [], spans, 0.0, 100.0)
    job = ("job", 0.0, 100.0)
    prepare = ("prepare", 10.0, 30.0)
    assert read(span_run({}, stretch([job, prepare]))) == pytest.approx(20)
    nested = ("upload", 15.0, 5.0)
    assert read(span_run({}, stretch([job, prepare, nested]))) == \
        pytest.approx(15)
    assert read(span_run({}, stretch([job, ("stereo", 10.0, 30.0)]))) \
        is None
    assert read(span_run({})) is None
