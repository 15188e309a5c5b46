"""CPU tests of the benchmark harness: the work arithmetic against hand
counts, the inputs' seeding, BENCHMARK.json's form, the metric files,
the refusal without a card, and whole runs of a tiny cell on the CPU in
which the check passes, and fails under each fault the cells can have."""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from port_bench import harness, images, work
from port_bench.tests import tiny

ROOT = os.path.dirname(tiny.BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(name):
    return harness.load_json(os.path.join(tiny.BENCH_DIR, "configs",
                                          f"{name}.json"))


def work_module(name):
    return harness.load_file(os.path.join(tiny.BENCH_DIR, "configs",
                                          f"{name}_work.py"), f"w_{name}")


# -- arithmetic -----------------------------------------------------------

def test_beit_flops_at_n_1793():
    """BEiT-L 512 on a 1080p photo at net 512 ("minimal"): 512 x 896, a
    32 x 56 grid, N = 1793.  By hand: the blocks 24 x (2 N C (3C + C +
    2 x 4C) + 4 N^2 C) = 1399.0 GFLOP; the patch embedding 2.8; the
    reassemble 56.4 (readout 30.1, 1x1 10.3, resizes 16.0); the decoder
    361.4 (layer_rn 61.3, refinenets 198.7 at 28,672 / 7,168 / 1,792 /
    448 pixels, head 101.4 at 114,688 and 458,752): 1.82 TFLOP."""
    cfg = load_config("dpt_beit_large_512")
    from port_bench.reference.common import net_input_size
    assert net_input_size(cfg, 1920, 1080, 512, 512) == (512, 896)
    n, c = 1793, 1024
    blocks = 24 * (2 * n * c * 12 * c + 4 * n * n * c)
    assert work.vit_blocks(n, c, 24, 4096) == blocks
    total = work_module("dpt_beit_large_512").flops_per_image(cfg,
                                                              (512, 896))
    patch = 2 * 1792 * c * 3 * 16 * 16
    readout = 4 * 2 * 1792 * 2 * c * c
    proj = 2 * 1792 * c * (256 + 512 + 1024 + 1024)
    resize = 2 * 1792 * (256 * 256 * 16 + 512 * 512 * 4) + \
        2 * 448 * 1024 * 1024 * 9
    f = 256

    def k3(px, cin, cout):
        return 2 * px * cin * cout * 9
    lv = (28672, 7168, 1792, 448)
    layer_rn = k3(lv[0], 256, f) + k3(lv[1], 512, f) + \
        k3(lv[2], 1024, f) + k3(lv[3], 1024, f)
    fusion = 2 * k3(lv[3], f, f) + 2 * 1792 * f * f + \
        4 * k3(lv[2], f, f) + 2 * 7168 * f * f + \
        4 * k3(lv[1], f, f) + 2 * 28672 * f * f + \
        4 * k3(lv[0], f, f) + 2 * 114688 * f * f
    head = k3(114688, f, 128) + k3(458752, 128, 32) + 2 * 458752 * 32
    hand = blocks + patch + readout + proj + resize + layer_rn + fusion + \
        head
    assert total == pytest.approx(hand, rel=1e-12)
    assert total == pytest.approx(1.8196e12, rel=1e-3)


def test_dinov2_attention_at_n_10765():
    """DA v2 Large on a 1080p photo, net matched (1920 x 1088 ->
    lower_bound, multiple of 14: 1932 x 1092, 78 x 138, N = 10,765):
    attention 24 x 4 N^2 C = 11.39 TFLOP of the blocks' 17.89 and the
    photo's 20.19 (the head at 14 gh x 14 gw adds 2.28)."""
    cfg = load_config("depth_anything_v2_large")
    from port_bench.reference.common import net_input_size
    assert net_input_size(cfg, 1920, 1080, 1920, 1088) == (1092, 1932)
    n = 78 * 138 + 1
    assert n == 10765
    att = work.attention_ops(n, 1024, 24)
    assert att == 24 * 4 * 10765 ** 2 * 1024
    assert att == pytest.approx(11.39e12, rel=1e-3)
    total = work_module("depth_anything_v2_large").flops_per_image(
        cfg, (1092, 1932))
    blocks = 24 * (2 * n * 1024 * 12 * 1024) + att
    assert blocks == pytest.approx(17.89e12, rel=1e-3)
    assert total == pytest.approx(20.19e12, rel=1e-3)


def test_attention_roofline_arithmetic():
    """(8, 16, 1793) bf16 with BEiT's table: ops-bound at 105.3 GFLOP,
    0.1065 ms at 989 TFLOP/s; bytes 4 x 8 x 16 x 1793 x 64 x 2 plus the
    table's (63 x 111 + 3) x 16 x 2."""
    cfg = load_config("dpt_beit_large_512")
    calls = work_module("dpt_beit_large_512").attention_per_forward(
        cfg, (512, 896), 8)
    assert len(calls) == 24
    c = calls[0]
    assert c["ops"] == 4 * 8 * 16 * 1793 ** 2 * 64
    assert c["bytes"] == 4 * 8 * 16 * 1793 * 64 * 2 + (63 * 111 + 3) * 32
    t = work.least_seconds(c, 989e12, 3.35e12)
    assert t == pytest.approx(c["ops"] / 989e12)
    assert work.least_seconds({"ops": 1.0, "bytes": 3.35e12}, 989e12,
                              3.35e12) == 1.0


def test_conv_counts():
    assert work.conv((4, 5), 3, 7, 3) == 2 * 20 * 3 * 7 * 9
    assert work.conv_transpose((4, 5), 8, 8, 4) == 2 * 20 * 8 * 8 * 16
    assert work.level_sizes((5, 7))[3] == (3, 4)


# -- weights --------------------------------------------------------------

@pytest.mark.parametrize("config_name", ["dpt_beit_large_512",
                                         "depth_anything_v2_large"])
def test_seeded_weights(config_name):
    """The rule: std 1/sqrt(fan_in), norms and layer scales 1, biases 0,
    tables 0.02; the configuration's last convolution positive; the same
    seed gives the same values, in the module's dtypes."""
    import torch
    from port_bench import weights
    module = tiny.beit_module() if "beit" in config_name else \
        tiny.dino_module()
    positive = tiny.config(config_name)["positive_weights"]
    leaves = weights.plan(module, positive)
    a = weights.make(leaves, 2 ** 31 + 5, "cpu")
    b = weights.make(leaves, 2 ** 31 + 5, "cpu")
    c = weights.make(leaves, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[positive[0]], c[positive[0]])
    assert bool((a[positive[0]] >= 0).all())
    for name, t in a.items():
        if name.endswith("norm1.weight") or name.endswith("gamma"):
            assert bool((t == 1).all()), name
        if name.endswith(".bias"):
            assert bool((t == 0).all()), name
    qkv = next(k for k in a if k.endswith("attn.qkv.weight"))
    assert float(a[qkv].std()) == pytest.approx(64 ** -0.5, rel=0.05)
    weights.load(module, a)
    with pytest.raises(KeyError):
        weights.plan(module, ["no.such.weight"])


# -- inputs ---------------------------------------------------------------

def test_inputs_follow_the_seed():
    spec = {"width": 64, "height": 40, "shapes": 5, "texture": 18.0,
            "noise": 4.0}
    big = 2 ** 31 + 12345
    a = images.photo_pool(spec, 3, big, "cpu")
    b = images.photo_pool(spec, 3, big, "cpu")
    c = images.photo_pool(spec, 3, big + 1, "cpu")
    assert all(x.shape == (40, 64, 3) and x.dtype == np.uint8 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert not np.array_equal(a[0], a[1])


# -- BENCHMARK.json -----------------------------------------------------

def test_benchmark_names_and_units():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    b = bench_json()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["end_to_end"] + b["per_layer"]:
        path = os.path.join(tiny.BENCH_DIR, "metrics", f"{m['name']}.py")
        assert hasattr(harness.load_file(path, "r"), "read"), path
    for m in b["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in target.get("workloads", cells), (m, cell)
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], b)
        assert cell.limits(), w["name"]
        assert any(m["name"] != "setup_s" for m in cell.metrics(False))
        assert cell.metrics(True)
        assert os.path.exists(os.path.join(
            tiny.BENCH_DIR, "reference", f"{cell.config['reference']}.py"))


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "port_bench", "run.py"),
         "--workload", "beit512-1080p-stereo", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "metrics" not in proc.stdout


# -- whole runs of a tiny cell on the CPU -------------------------------

LIMITS = {"depth_fit_vs_bf16": 12, "depth_range_off": 0,
          "stereo_bytes_off": 0, "photos_short": 0}


def tiny_run(monkeypatch, seed=2 ** 31 + 7):
    monkeypatch.setenv("DEPTHMAP_COMPUTE_DTYPE", "float32")
    tiny.patch_builders(monkeypatch)
    cell = tiny.cell("tiny-stereo", "dpt_beit_large_512",
                     tiny.STEREO_TRAFFIC, LIMITS)
    return harness.run_cell(cell, seed, 0.0, False, "cpu")


def test_sound_run_is_correct(monkeypatch):
    res = tiny_run(monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["metrics"]["images_per_s"]["value"] > 0


def _altered_map(monkeypatch):
    """Each depth map altered where it is produced: mirrored."""
    from depthmap_tpu_torch.ops import numerics
    real = numerics.finalize_i16
    monkeypatch.setattr(numerics, "finalize_i16",
                        lambda *a, **k: real(*a, **k).flip(-1))


def _inverted_map(monkeypatch):
    """Each depth map inverted where it is produced (far is near)."""
    from depthmap_tpu_torch.ops import numerics
    real = numerics.finalize_i16
    monkeypatch.setattr(
        numerics, "finalize_i16",
        lambda *a, **k: numerics.invert_i16(real(*a, **k)))


def _altered_eye(monkeypatch):
    """One byte of every row of every eye altered where it is made."""
    from depthmap_tpu_torch.ops import stereo
    real = stereo.polylines_rasterize

    def broken(*a, **k):
        out = real(*a, **k).clone()
        out[..., 0, 0] ^= 1
        return out
    monkeypatch.setattr(stereo, "polylines_rasterize", broken)


def _half_batch(monkeypatch):
    """The forward runs on half of each batch; the rest takes its maps."""
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    real = DepthPredictor._raw_batch

    def broken(self, imgs01, *a, **k):
        half = max(len(imgs01) // 2, 1)
        raw = real(self, imgs01[:half], *a, **k)
        return raw[[i % half for i in range(len(imgs01))]]
    monkeypatch.setattr(DepthPredictor, "_raw_batch", broken)


def _lost_output(monkeypatch):
    """The funnel drops the anaglyph of every photo."""
    from depthmap_tpu_torch.pipeline import core
    real = core.core_generation_funnel

    def broken(*a, **k):
        for item in real(*a, **k):
            if item[1] != "red-cyan-anaglyph":
                yield item
    monkeypatch.setattr(core, "core_generation_funnel", broken)


@pytest.mark.parametrize("fault", [_altered_map, _inverted_map, _altered_eye,
                                   _half_batch, _lost_output])
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res = tiny_run(monkeypatch)
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_metric_readers_without_a_trace():
    """The host-clock readers read the window; the trace readers find
    nothing to read and leave their metrics out."""
    win = harness.Window(jobs=2, photos=16, attempted=16, seconds=2.0,
                         job_s=[1.0, 1.0], peak_bytes=3 * 2 ** 30,
                         spans={"stereo": [0.5, 0.5]})
    cell = harness.load_cell("beit512-1080p-stereo")
    run = harness.Run(cell, 12.5, win, cell.work(), (512, 896), None)
    got = harness.read_metrics(run, cell.metrics(False) + cell.metrics(True))
    assert got["images_per_s"]["value"] == 8.0
    assert got["peak_mem_gib"]["value"] == 3.0
    assert got["setup_s"]["value"] == 12.5
    assert got["stereo_ms_per_image"]["value"] == pytest.approx(62.5)
    for name in ("device_idle_share", "model_mfu", "k1_roofline",
                 "k2_roofline", "copy_ms_per_image", "photo_s_p95"):
        assert name not in got
    assert math.isfinite(got["images_per_s"]["value"])
