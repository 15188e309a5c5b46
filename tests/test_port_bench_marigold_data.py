"""The Marigold configuration's data held to the program and to its own
arithmetic: the traffic's options against the configuration, the launch
check's count against the UNet's transformers, the processing size
against the pipeline's, the work count against FlopCounterMode on meta
tensors, the single-photo stereo cell's limits against the batched one's,
and the two span readers on a hand-built trace with correlation ids."""
from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from depthmap_tpu_torch.models.marigold import unet, vae
from depthmap_tpu_torch.models.marigold.pipeline import MarigoldPipeline
from port_bench import harness, trace
from port_bench.reference.common import net_input_size

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "marigold-1080p-e1s12"


def cell():
    return harness.load_cell(CELL)


def test_traffic_options_are_the_configuration():
    c = cell()
    opts = c.traffic["options"]
    assert opts["marigold_ensembles"] == c.config["ensemble_size"] == 1
    assert opts["marigold_steps"] == c.config["denoising_steps"] == 12


def test_launch_count_is_two_per_transformer_and_step():
    with torch.device("meta"):
        net = unet.MarigoldUNet()
    blocks = sum(isinstance(m, unet.TransformerBlock) for m in net.modules())
    cfg = cell().config
    assert blocks == cfg["unet"]["transformers"] == 16
    assert cfg["num_hidden_layers"] == 2 * blocks * cfg["denoising_steps"]


def test_processing_size_is_the_pipelines():
    c = cell()
    photo = c.traffic["photo"]
    w, h = photo["width"], photo["height"]
    nw, nh = harness.net_size(c, w, h)
    assert net_input_size(c.config, w, h, nw, nh) == \
        MarigoldPipeline.processing_size(h, w, nw) == (432, 768)


@pytest.mark.parametrize("hw", [(64, 96), (72, 104)])
def test_work_count_matches_flop_counter(hw):
    """The published widths on meta tensors, at a small latent."""
    c = cell()
    work, cfg = c.work(), c.config
    with torch.device("meta"):
        u, v = unet.MarigoldUNet(), vae.AutoencoderKL()
        x = torch.empty(1, 3, *hw)
        lat = torch.empty(1, 8, hw[0] // 8, hw[1] // 8)
        ctx = torch.empty(1, 77, 1024)
        ts = torch.ones(1, dtype=torch.int32)
        counted = []
        for fn in (lambda: v.encode_mean(x), lambda: u(lat, ts, ctx),
                   lambda: v.decode(lat[:, :4])):
            with FlopCounterMode(display=False) as f:
                fn()
            counted.append(f.get_total_flops())
    ours = [work.vae_encode_flops(cfg, hw), work.unet_flops(cfg, hw),
            work.vae_decode_flops(cfg, hw)]
    for got, want in zip(ours, counted):
        assert abs(got / want - 1) < 0.03
    per_eval = work.attention_per_forward(cfg, hw, 1)
    assert len(per_eval) == cfg["num_hidden_layers"]


def test_single_stereo_cell_keeps_the_batched_cells_limits():
    a, b = (harness.load_cell(n) for n in ("beit512-1080p-single-stereo",
                                           "beit512-1080p-stereo"))
    assert a.limits() == b.limits()
    assert a.traffic["options"] == b.traffic["options"]
    assert a.traffic["photos_per_job"] == 1 and a.config == b.config


def _trace_file(path):
    """Two UNet spans on thread 1, whose kernels run after the spans
    close (the host runs ahead), an encode and a decode span, and a
    kernel launched outside any span that runs inside the second UNet
    span's time."""
    def span(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur, "tid": tid}

    def launch(corr, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(corr, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
                "dur": dur, "tid": 7, "args": {"correlation": corr}}
    events = [span("job", 0, 1000), span("marigold_encode", 10, 10),
              span("marigold_unet", 30, 10), span("marigold_unet", 50, 10),
              span("marigold_decode", 70, 10),
              launch(1, 12), kernel(1, 100, 40),
              launch(2, 32), kernel(2, 140, 200), launch(3, 35),
              kernel(3, 340, 100),
              launch(4, 52), kernel(4, 440, 300),
              launch(5, 62), kernel(5, 55, 5),
              launch(6, 72), kernel(6, 740, 60),
              launch(7, 75, tid=2), kernel(7, 800, 1000)]
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
    run = harness.Run(c, 1.0, harness.Window(), c.work(), (432, 768), None,
                      stretch)

    def read(name):
        return harness.load_file(os.path.join(
            ROOT, "port_bench", "metrics", f"{name}.py"), f"r_{name}"
        ).read(run)
    # (200 + 100 + 300) us over two UNet spans; (40 + 60) us over 2 photos
    assert read("unet_ms_per_eval") == pytest.approx(0.3)
    assert read("vae_ms_per_image") == pytest.approx(0.05)
    run.trace = None
    assert read("unet_ms_per_eval") is None
    assert read("vae_ms_per_image") is None
    run.trace = stretch
    monkeypatch.setattr(harness, "CHROME_TRACE", str(tmp_path / "none"))
    assert read("unet_ms_per_eval") is None
