"""The ZoeDepth K configuration's data held to the program and to its own
arithmetic: the widths against the program's build, the net input the
harness's forward hook reads and the one the module makes for the cell's
photos, K1's tier there, the work count against FlopCounterMode on meta
tensors, and the two span readers on a hand-built trace with correlation
ids."""
from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from depthmap_tpu_torch.models import beit
from depthmap_tpu_torch.models import zoedepth as zd
from port_bench import harness, trace
from port_bench.reference import zoedepth as ref
from port_bench.reference.common import net_input_size

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "zoedepth_k-photos"


def cell():
    return harness.load_cell(CELL)


def test_widths_are_the_programs():
    cfg = cell().config
    with torch.device("meta"):
        module = zd.build_zoedepth("k")
    m = module.model
    bb = m.core.core.pretrained
    assert list(module.img_size) == cfg["img_size"]
    assert (bb.model.cls_token.shape[-1], bb.depth, bb.hooks) == \
        (cfg["hidden_size"], cfg["num_hidden_layers"], tuple(cfg["hooks"]))
    assert m.conv2.in_channels == cfg["features"]
    seed = m.seed_bin_regressor
    assert (seed.min_depth, seed.max_depth) == (cfg["min_depth"],
                                                cfg["max_depth"])
    assert seed._net[0].out_channels == cfg["seed_mlp_dim"]
    assert seed._net[2].out_channels == cfg["n_bins"]
    assert [a.n_attractors for a in m.attractors] == cfg["n_attractors"]
    assert all((a.kind, a.attractor_type) == (cfg["attractor_kind"],
                                              cfg["attractor_type"])
               for a in m.attractors)
    assert m.projectors[0]._net[2].out_channels == cfg["bin_embedding_dim"]
    assert m.projectors[0]._net[0].out_channels == cfg["projector_mlp_dim"]
    assert m.attractors[0]._net[0].out_channels == cfg["attractor_mlp_dim"]
    clb = m.conditional_log_binomial
    assert (clb.n_classes, clb.min_temp, clb.max_temp) == (
        cfg["n_bins"], cfg["min_temp"], cfg["max_temp"])
    assert clb.mlp[0].out_channels == (33 + cfg["bin_embedding_dim"]) // \
        cfg["log_binomial_bottleneck_factor"]


def test_net_input_and_k1_tier_at_the_cells_photos():
    """The hook reads the photo (the module's input), which the
    configuration's preprocess gives at the matched net; the module and
    the reference make 1120 x 1920 of it (N = 8401), whose bias streams
    (K1's table mode) and is not hoisted."""
    c = cell()
    photo = c.traffic["photo"]
    w, h = photo["width"], photo["height"]
    nw, nh = harness.net_size(c, w, h)
    assert (nw, nh) == (1920, 1088)
    assert net_input_size(c.config, w, h, nw, nh) == (h, w)
    hw = zd.ZoeDepthInference.net_input_size(h, w, (nh, nw),
                                             tuple(c.config["img_size"]))
    assert hw == ref.net_input((h, w), (nh, nw)) == (1120, 1920)
    gh, gw = c.work().grid(c.config, (h, w))
    n = gh * gw + 1
    assert n == 8401
    heads = c.config["num_attention_heads"]
    assert beit.streams_bias(heads, n, torch.bfloat16)
    assert c.config["num_hidden_layers"] * heads * n * n * 2 > \
        beit.BIAS_HOIST_CAP


@pytest.mark.parametrize("photo", [(64, 96), (72, 128)])
def test_work_count_matches_flop_counter(photo):
    """Both copies of one photo through the published widths on meta
    tensors, at a small matched net."""
    c = cell()
    hw = ref.net_input(photo, ref.matched_net(photo))
    with torch.device("meta"):
        model = zd.build_zoedepth("k").model
        with FlopCounterMode(display=False) as f:
            model(torch.empty(2, 3, *hw))
    got = c.work().flops_per_image(c.config, photo)
    assert abs(got / f.get_total_flops() - 1) < 0.03


def test_attention_count_is_table_mode_over_both_copies():
    c = cell()
    calls = c.work().attention_per_forward(c.config, (1080, 1920), 8)
    assert len(calls) == 24
    table = (2 * 70 - 1) * (2 * 120 - 1) + 3
    assert calls[0]["ops"] == 4.0 * 16 * 16 * 8401 ** 2 * 64
    assert calls[0]["bytes"] == 4.0 * 16 * 16 * 8401 * 64 * 2 + \
        table * 16 * 4


def _trace_file(path):
    """A core span and two head spans on thread 1, whose kernels run
    after the spans close (the host runs ahead), and a kernel launched
    outside any span that runs inside the second head span's time."""
    def span(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur, "tid": 1}

    def launch(corr, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(corr, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
                "dur": dur, "tid": 7, "args": {"correlation": corr}}
    events = [span("job", 0, 2000), span("zoe_core", 10, 20),
              span("zoe_head", 40, 10), span("zoe_head", 60, 10),
              launch(1, 12), kernel(1, 100, 400),
              launch(2, 42), kernel(2, 500, 60),
              launch(3, 62), kernel(3, 560, 40),
              launch(4, 80), kernel(4, 65, 5),
              launch(5, 64, tid=2), kernel(5, 600, 1000)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_span_readers_match_kernels_to_their_launches(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "trace.json")
    _trace_file(path)
    monkeypatch.setattr(harness, "CHROME_TRACE", path)
    stretch = trace.read_chrome_trace(path)
    stretch.photos = 2
    c = cell()
    run = harness.Run(c, 1.0, harness.Window(), c.work(), (1080, 1920),
                      None, stretch)

    def read(name):
        return harness.load_file(os.path.join(
            ROOT, "port_bench", "metrics", f"{name}.py"), f"r_{name}"
        ).read(run)
    # 400 us of core, (60 + 40) us of head, over 2 photos
    assert read("zoe_core_ms_per_image") == pytest.approx(0.2)
    assert read("zoe_head_ms_per_image") == pytest.approx(0.05)
    run.trace = None
    assert read("zoe_core_ms_per_image") is None
    assert read("zoe_head_ms_per_image") is None
    run.trace = stretch
    monkeypatch.setattr(harness, "CHROME_TRACE", str(tmp_path / "none"))
    assert read("zoe_head_ms_per_image") is None
    # a program without the spans (the parent's): nothing to read
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if not e["name"].startswith("zoe_")]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    monkeypatch.setattr(harness, "CHROME_TRACE", path)
    assert read("zoe_core_ms_per_image") is None
    assert read("zoe_head_ms_per_image") is None
