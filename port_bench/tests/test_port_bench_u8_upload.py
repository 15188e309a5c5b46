"""CPU test of the reader of the uint8 upload's share of the forwards:
the window's ``upload_u8`` spans over its ``upload`` spans."""
from __future__ import annotations

import os

import pytest

from port_bench import harness
from port_bench.tests import tiny


def read(spans):
    reader = harness.load_file(os.path.join(
        tiny.BENCH_DIR, "metrics", "u8_upload_share.py"), "r_u8_upload")
    win = harness.Window(jobs=2, photos=16, attempted=16, seconds=2.0,
                         job_s=[1.0, 1.0], spans=spans)
    cell = harness.load_cell("beit512-1080p-stereo")
    return reader.read(harness.Run(cell, 12.5, win, cell.work(),
                                   (512, 896), None))


@pytest.mark.parametrize("spans,want", [
    ({"upload": [0.01, 0.02], "upload_u8": [0.005, 0.01]}, 100.0),
    ({"upload": [0.01] * 4, "upload_u8": [0.005]}, 25.0),
    ({"upload": [0.01, 0.02], "forward": [0.1]}, 0.0),
    ({"prepare": [0.1]}, None),
    ({}, None),
])
def test_u8_upload_share(spans, want):
    """All, a quarter and none of the forwards on the uint8 route; no
    upload span (no forward on the card's route at all) reads None."""
    assert read(spans) == (want if want is None else pytest.approx(want))
