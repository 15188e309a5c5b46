"""CPU test of the reader of the share of the stereo photos that ran on
the card-resident chunk: the window's ``stereo_on_card`` spans over its
``stereo`` spans."""
from __future__ import annotations

import os

import pytest

from port_bench import harness
from port_bench.tests import tiny


def read(spans):
    reader = harness.load_file(os.path.join(
        tiny.BENCH_DIR, "metrics", "stereo_card_share.py"), "r_stereo_card")
    win = harness.Window(jobs=2, photos=16, attempted=16, seconds=2.0,
                         job_s=[1.0, 1.0], spans=spans)
    cell = harness.load_cell("beit512-1080p-stereo")
    return reader.read(harness.Run(cell, 12.5, win, cell.work(),
                                   (512, 896), None))


@pytest.mark.parametrize("spans,want", [
    ({"stereo": [0.004] * 16, "stereo_on_card": [0.003] * 16}, 100.0),
    ({"stereo": [0.004] * 4, "stereo_on_card": [0.003]}, 25.0),
    ({"stereo": [0.008] * 16, "stereo_upload": [0.001] * 16}, 0.0),
    ({"upload": [0.01], "forward": [0.1]}, None),
])
def test_stereo_card_share(spans, want):
    """Every, a quarter and none of the stereo photos on the card's route;
    no stereo span (a cell without stereo) reads None."""
    assert read(spans) == (want if want is None else pytest.approx(want))
