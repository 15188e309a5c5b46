"""ZoeDepth K (type 8) on the port's normal path, held to the benchmark's
plain reference (port_bench/reference/zoedepth.py) by the benchmark's own
check, on a tiny core on the CPU: BEiT 64 wide, 4 blocks of 2 heads,
reassemble 16/32/64/64, features 32, under the published head (64 bins,
bin embedding 128, attractors 16/8/4/1, depth 1e-3 to 80).

The harness drives the funnel with the cell's matched net, as on the card,
on two photo shapes: 128 x 72 (matched net 128 x 96, net input 96 x 160)
and 96 x 64 (the matched net is the photo; net input 64 x 96).  The sound
run is correct; each planted fault (the per-pixel sort skipped, the
attractors summed instead of averaged) makes it incorrect.  The forward
hook sees the photos as the module receives them, which is what the
configuration's ``preprocess`` gives.  The metric head in several slices
equals the head in one, for n, k and nk, one ``zoe_head`` span a slice.  A
resize whose batch output passes a 32-bit element count (the decoder's
2x upsamples of 16 copies at the cell's net input) runs a few images at
a time, equal to the one call.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from depthmap_tpu_torch.models import zoedepth as zd
from depthmap_tpu_torch.models.beit import BeitBackbone
from depthmap_tpu_torch.models.dpt import DPTDepthModel
from depthmap_tpu_torch.utils import profiling
from port_bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "zoedepth_k-photos"
SEED = 2 ** 31 + 23
CORE = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
            head_dim=32, intermediate_size=256, image_size=64,
            hooks=[0, 1, 2, 3], reassemble_channels=[16, 32, 64, 64],
            features=32)
SHAPES = {"128x72": (128, 72, (96, 160)), "96x64": (96, 64, (64, 96))}


def tiny_core() -> DPTDepthModel:
    return DPTDepthModel(
        BeitBackbone(embed_dim=CORE["hidden_size"],
                     depth=CORE["num_hidden_layers"],
                     num_heads=CORE["num_attention_heads"],
                     hooks=tuple(CORE["hooks"]),
                     train_img_size=CORE["image_size"]),
        tuple(CORE["reassemble_channels"]), CORE["features"],
        with_zoe_taps=True)


def tiny_model(variant: str) -> zd.ZoeDepthInference:
    """``build_zoedepth(variant)`` on the tiny core."""
    core = tiny_core()
    if variant == "n":
        return zd.ZoeDepthInference(zd.ZoeDepth(core, max_depth=10.0))
    if variant == "k":
        return zd.ZoeDepthInference(
            zd.ZoeDepth(core, max_depth=80.0, bin_centers_type="normed"),
            (384, 768))
    return zd.ZoeDepthInference(zd.ZoeDepthNK(core))


def tiny_cell(width: int, height: int):
    cell = harness.load_cell(CELL)
    with open(os.path.join(ROOT, "port_bench", "limits",
                           f"{CELL}.json")) as f:
        limits = json.load(f)

    class TinyCell(harness.Cell):
        def limits(self):
            return dict(limits)
    traffic = dict(cell.traffic, pool=2, photos_per_job=2, trace_jobs=1,
                   check={"photos": 2})
    traffic["photo"] = dict(traffic["photo"], width=width, height=height,
                            shapes=4)
    config = dict(cell.config, **CORE)
    return TinyCell(CELL, cell.workload, config, traffic, cell.bench)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(zd, "build_zoedepth", tiny_model)
    monkeypatch.delenv("DEPTHMAP_COMPUTE_DTYPE", raising=False)
    monkeypatch.delenv("DEPTHMAP_ZOE_KNK_HEAD_F32", raising=False)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_normal_path_matches_the_reference(tiny, shape):
    width, height, net_in = SHAPES[shape]
    cell = tiny_cell(width, height)
    bench = harness.Bench(cell, SEED, "cpu")
    bench.setup()
    assert bench.net_hw == (height, width)
    bench.window(0.0)
    assert bench.forwards == [(2, (height, width))]
    names = [s.name for s in profiling.spans()]
    for name, count in (("zoe_tta", 2), ("zoe_core", 1), ("zoe_head", 1),
                        ("upload_u8", 1), ("zoe_vote", 0)):
        assert names.count(name) == count, name
    module = bench.predictor.bundle.module
    assert module.net_input_size(height, width, (
        (height + 31) // 32 * 32, (width + 31) // 32 * 32),
        module.img_size) == net_in
    bench.release()
    checks = bench.check()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert checks["depth_fit_vs_bf16"]["value"] > 0
    assert not bench.problems


def _sorted_descending(monkeypatch):
    """The program's attractors sort their centers in descending order."""
    def forward(self, x, b_prev, prev_b_embedding=None):
        x = x + zd.interpolate(prev_b_embedding, x.shape[2:], "bilinear",
                               True)
        a = self._net(x) + 1e-3
        n, _, h, w = a.shape
        a = a.view(n, self.n_attractors, 2, h, w)[:, :, 0]
        b_prev = zd.interpolate(b_prev, x.shape[2:], "bilinear", True)
        b_new = zd._attract(a, b_prev, self.kind, self.attractor_type)
        centers = (self.max_depth - self.min_depth) * b_new + self.min_depth
        centers = torch.sort(centers, 1, descending=True).values
        return b_new, centers.clamp(self.min_depth, self.max_depth)
    monkeypatch.setattr(zd.AttractorLayerNormed, "forward", forward)


def _attractors_summed(monkeypatch):
    """Every attractor layer sums its points' pulls instead of averaging
    them."""
    real = zd._attract
    monkeypatch.setattr(zd, "_attract", lambda a, b, kind, t:
                        real(a, b, "sum", t))


def _mirror_not_flipped_back(monkeypatch):
    """The mirrored copy's map is averaged in without flipping it back."""
    real = zd.ZoeDepthInference.forward

    def forward(self, x01, net_size=None, **grid_inputs):
        n = x01.shape[0]
        both = real(self, torch.cat([x01, x01.flip(-1)]), net_size,
                    **grid_inputs)
        return (both[:n] + both[n:]) / 2.0
    monkeypatch.setattr(zd.ZoeDepthInference, "forward", forward)


@pytest.mark.parametrize("fault", [_sorted_descending, _attractors_summed,
                                   _mirror_not_flipped_back])
def test_a_fault_makes_the_run_incorrect(tiny, monkeypatch, fault):
    cell = tiny_cell(*SHAPES["128x72"][:2])
    res = harness.run_cell(cell, SEED, 0.0, False, "cpu")
    assert res["correct"] and res["failed"] == 0, res["checks"]
    fault(monkeypatch)
    res = harness.run_cell(cell, SEED, 0.0, False, "cpu")
    assert res["attempted"] == 2 and res["failed"] == 0
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("variant", ["n", "k", "nk"])
def test_head_in_slices_equals_one_slice(monkeypatch, variant):
    """Three photos (six copies with the mirror) at a 64 x 96 net input:
    one slice under the module's constant, six when it holds one copy a
    slice; the same maps to f32 rounding.  Every operation of the head is
    per copy; the CPU's convolutions block a batch of six otherwise than
    one copy and sum in another order, which moves the centers by a few
    ulp (3e-5 of 80 on this seed)."""
    torch.manual_seed(5)
    model = tiny_model(variant)
    from depthmap_tpu_torch.models import weights
    weights.init_random_(model, seed=7)
    model.eval()
    x = torch.rand(3, 3, 48, 80)
    per_copy = 4 * 64 * 96 * sum(
        m.fullres_channels() for m in model.modules()
        if isinstance(m, zd.ConditionalLogBinomial))
    out = {}
    for cap, slices in ((zd.HEAD_SLICE_BYTES, 1), (per_copy, 6)):
        monkeypatch.setattr(zd, "HEAD_SLICE_BYTES", cap)
        profiling.reset()
        with torch.no_grad():
            out[slices] = model(x, net_size=(64, 64))
        names = [s.name for s in profiling.spans()]
        assert names.count("zoe_head") == slices
        assert names.count("zoe_vote") == (variant == "nk")
    assert out[1].shape == (3, 48, 80)
    torch.testing.assert_close(out[6], out[1], rtol=1e-6, atol=0)


def test_slice_size_at_the_cell_shape():
    """At the cell's net input (16 copies of 1120 x 1920) K's head takes
    one copy a slice; at K's default 768 x 768, four."""
    with torch.device("meta"):
        model = zd.build_zoedepth("k").model
    assert len(model.head_slices(16, (1120, 1920))) == 16
    assert [s.stop - s.start for s in model.head_slices(8, (768, 768))] \
        == [4, 4]
    clb = model.conditional_log_binomial
    assert clb.fullres_channels() == 161 + 128 + 2 * 80 + 4 + 5 * 64
    assert np.prod((1120, 1920)) * 4 * clb.fullres_channels() < \
        zd.HEAD_SLICE_BYTES


@pytest.mark.parametrize("mode,align", [("bilinear", True),
                                        ("bicubic", False)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_resize_over_the_element_limit_runs_in_parts(monkeypatch, mode,
                                                     align, channels_last):
    from depthmap_tpu_torch.ops import resize
    x = torch.randn(5, 3, 6, 7)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    want = torch.nn.functional.interpolate(x, size=(12, 14), mode=mode,
                                           align_corners=align)
    monkeypatch.setattr(resize, "MAX_RESIZE_ELEMENTS", 2 * 3 * 12 * 14)
    got = resize.interpolate(x, (12, 14), mode, align)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last) == \
        channels_last
