"""Marigold (type 10) on the port's normal path, held to the benchmark's
plain reference (port_bench/reference/marigold.py) by the benchmark's own
check, on a small pipeline on the CPU: UNet base 32 (heads of 16),
context 64, VAE base 32, a 120 x 80 uint8 photo at net 96 (processing 96 x
64, latent 12 x 8), one member, 2 steps.

The harness drives the funnel with the traffic's options, as on the card;
the weights are the benchmark's seeded ones, with the empty prompt's
embedding drawn too (the seeded weights leave the buffer zero, and a zero
context makes every cross-attention output its zero bias, so a skipped one
would pass).  The sound run is correct, with a live map to compare; each
planted fault (v-prediction's sign, cross-attention skipped,
``steps_offset`` 0) makes it incorrect; the reference in float8 reads above
the program.  The forward hook sees the (1, 3, 64, 96) net input, and the
window's spans are the uint8 upload and Marigold's own.
"""
from __future__ import annotations

import json
import os

import pytest
import torch

from depthmap_tpu_torch.models.marigold import ddim, unet
from depthmap_tpu_torch.models.marigold import pipeline as mp
from depthmap_tpu_torch.utils import profiling
from port_bench import compare, harness, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS_FILE = os.path.join(ROOT, "port_bench", "limits",
                           "marigold-1080p-e1s12.json")
STEPS = 2
SEED = 2 ** 31 + 11
TRAFFIC = {"photo": {"width": 120, "height": 80, "shapes": 4,
                     "texture": 18.0, "noise": 4.0},
           "pool": 2, "photos_per_job": 1, "net": "default",
           "options": {"marigold_ensembles": 1, "marigold_steps": STEPS},
           "trace_jobs": 1, "check": {"photos": 1}}


def small_config() -> dict:
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "marigold_v1.json")) as f:
        cfg = json.load(f)
    cfg["unet"].update(block_out_channels=[32, 64, 128, 128],
                       attention_head_dim=16, cross_attention_dim=64,
                       time_embedding_dim=128)
    cfg["vae"]["block_out_channels"] = [32, 64, 128, 128]
    cfg.update(default_net_size=[96, 96], denoising_steps=STEPS,
               num_hidden_layers=2 * 16 * STEPS)
    return cfg


def small_cell():
    with open(LIMITS_FILE) as f:
        limits = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)

    class SmallCell(harness.Cell):
        def limits(self):
            return dict(limits)
    workload = {"name": "small-marigold", "config": "marigold_v1",
                "traffic": "small", "chips": 1}
    return SmallCell("small-marigold", workload, small_config(), TRAFFIC,
                     bench)


@pytest.fixture
def small(monkeypatch):
    """build_model(10) gives the small pipeline; the seeded weights carry
    a drawn empty-prompt embedding to both sides."""
    build = mp.build_marigold
    monkeypatch.setattr(mp, "build_marigold", lambda: build(
        base=32, vae_base=32, context_dim=64, dim_head=16))
    make = weights.make

    def with_context(leaves, seed, device, dtype=None):
        out = make(leaves, seed, device, dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        out["empty_text_embed"] = torch.randn(
            (1, mp.CONTEXT_LEN, 64), generator=gen, device=device)
        return out
    monkeypatch.setattr(weights, "make", with_context)
    return small_cell()


def test_normal_path_matches_the_reference(small):
    bench = harness.Bench(small, SEED, "cpu")
    bench.setup()
    evals = mp.MarigoldPipeline.unet_evals
    bench.window(0.0)
    names = [s.name for s in profiling.spans()]
    assert mp.MarigoldPipeline.unet_evals - evals == STEPS
    assert bench.forwards == [(1, (64, 96))]
    for name, count in (("upload", 1), ("upload_u8", 1),
                        ("marigold_resize", 2), ("marigold_encode", 1),
                        ("marigold_denoise", 1), ("marigold_unet", STEPS),
                        ("marigold_decode", 1), ("marigold_ensemble", 0)):
        assert names.count(name) == count, name
    bench.release()
    checks = bench.check()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert not bench.problems
    photos = [k["image"] for k in bench.kept]
    ref = compare.reference_maps(small, bench.leaves, SEED, "cpu", photos,
                                 "f32")
    assert compare.live_share(ref[0]) >= compare.LIVE_SHARE
    rounded = compare.reference_maps(small, bench.leaves, SEED, "cpu",
                                     photos, "bf16")
    fp8 = compare.reference_maps(small, bench.leaves, SEED, "cpu", photos,
                                 "fp8")
    program = compare.depth_numbers(
        [k["outputs"]["depth"] for k in bench.kept], ref, rounded)
    control = compare.depth_numbers(fp8, ref, rounded)
    assert control["depth_fit_vs_bf16"] > max(
        program["depth_fit_vs_bf16"], checks["depth_fit_vs_bf16"]["limit"])


def _v_sign(monkeypatch):
    """The UNet's v-prediction enters the update with its sign flipped."""
    real = unet.MarigoldUNet.forward
    monkeypatch.setattr(unet.MarigoldUNet, "forward",
                        lambda self, *a: -real(self, *a))


def _no_cross_attention(monkeypatch):
    """Every transformer block skips its cross-attention."""
    def forward(self, x, context):
        h = self.norm1(x)
        x = x + self.attn1(h, h)
        return x + self.ff.net[2](self.ff.net[0](self.norm3(x)))
    monkeypatch.setattr(unet.TransformerBlock, "forward", forward)


def _steps_offset_0(monkeypatch):
    """The timesteps the UNet sees are not shifted by one."""
    real = ddim.DDIMScheduler.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        self.steps_offset = 0
    monkeypatch.setattr(ddim.DDIMScheduler, "__init__", init)


@pytest.mark.parametrize("fault", [_v_sign, _no_cross_attention,
                                   _steps_offset_0])
def test_a_fault_makes_the_run_incorrect(small, monkeypatch, fault):
    fault(monkeypatch)
    res = harness.run_cell(small, SEED, 0.0, False, "cpu")
    assert res["attempted"] == 1 and res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_knobs_come_from_a_mapping_and_keep_the_predictor(small):
    """The funnel reads Marigold's knobs from a mapping ``inp`` (the REST
    API's options), ``ops`` winning; the cache keeps one predictor across
    knob changes and sets them on it."""
    import numpy as np
    from depthmap_tpu_torch.pipeline import core
    cache = core.PredictorCache()
    photo = [np.full((16, 24, 3), 128, np.uint8)]
    inp = {"model_type": 10, "compute_device": "CPU", "net_width": 24,
           "net_height": 24, "marigold_ensembles": 1, "MARIGOLD_STEPS": 1}
    seen = []
    for ops in (None, {"marigold_steps": 2}):
        evals = mp.MarigoldPipeline.unet_evals
        out = list(core.core_generation_funnel(None, photo, None, None, inp,
                                               ops, predictor_cache=cache))
        assert [o[1] for o in out] == ["depth"]
        seen.append((mp.MarigoldPipeline.unet_evals - evals,
                     cache._predictor))
    assert [n for n, _ in seen] == [1, 2]
    assert seen[0][1] is seen[1][1]
    assert (seen[1][1].marigold_ensembles, seen[1][1].marigold_steps) == \
        (1, 2)
