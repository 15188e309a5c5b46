"""The benchmark's plain references against the program's CPU path, at a
width a test can hold, on the same seeded weights; and the import rules:
no module of the benchmark loads JAX or the JAX package, and the
references load nothing of the program."""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from port_bench import compare, images, weights
from port_bench.reference import common, stereo
from port_bench.tests import tiny

BENCH_DIR = tiny.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "depthmap_tpu"}


def imported_tops(path: str):
    """The top-level names a module's import statements name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def modules_under(sub: str):
    root = os.path.join(BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    seen = {p: set(imported_tops(p)) & FORBIDDEN for p in modules_under("")}
    assert not {p: s for p, s in seen.items() if s}
    # the comparison is of whole names: the program is allowed
    assert "depthmap_tpu_torch" in set(
        imported_tops(os.path.join(BENCH_DIR, "harness.py")))


def test_references_import_nothing_of_the_program():
    for p in modules_under("reference"):
        assert "depthmap_tpu_torch" not in set(imported_tops(p)), p


def port_maps(monkeypatch, config_name, photos, net):
    """The program's uint16 maps of ``photos`` on the CPU in f32, its tiny
    model loaded with the benchmark's seeded weights, and the plan."""
    monkeypatch.setenv("DEPTHMAP_COMPUTE_DTYPE", "float32")
    tiny.patch_builders(monkeypatch)
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    pred = DepthPredictor(config_name, device="cpu")
    leaves = weights.plan(pred.bundle.module,
                          tiny.config(config_name)["positive_weights"])
    weights.load(pred.bundle.module, weights.make(leaves, 7, "cpu"))
    out = [pred.predict_finalized(p.astype(np.float32) / 255.0, *net)
           for p in photos]
    return out, leaves


@pytest.mark.parametrize("config_name,net,photo", [
    ("dpt_beit_large_512", (64, 64), (96, 64)),
    ("dpt_beit_large_512", (64, 64), (64, 96)),
    ("depth_anything_v2_large", (70, 70), (96, 64)),
    ("depth_anything_v2_large", (96, 64), (96, 64)),
])
def test_reference_matches_the_program(monkeypatch, config_name, net,
                                       photo):
    """Preprocess, backbone, head, upsample, finalize and uint16: within
    one step of the 16-bit map (f32 sums in another order)."""
    spec = {"width": photo[0], "height": photo[1], "shapes": 4,
            "texture": 18.0, "noise": 4.0}
    photos = images.photo_pool(spec, 2, 3, "cpu")
    got, leaves = port_maps(monkeypatch, config_name, photos, net)
    cfg = tiny.config(config_name)
    cell = tiny.cell("t", config_name, {"net": list(net)}, {})
    want = compare.reference_maps(cell, leaves, 7, "cpu", photos, "f32")
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == w.shape
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 2
        assert int(w.max()) - int(w.min()) > 60000   # not a flat map
    assert cfg["reference"] in ("beit_dpt", "dinov2_dpt")


def test_control_fails_where_the_program_passes(monkeypatch):
    """At the tiny width, the float8 control's gap from the f32 reference
    is several times the program's own (bf16 on the CPU)."""
    tiny.patch_builders(monkeypatch)
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    spec = {"width": 96, "height": 64, "shapes": 4, "texture": 18.0,
            "noise": 4.0}
    photos = images.photo_pool(spec, 3, 5, "cpu")
    pred = DepthPredictor("depth_anything_v2_large", device="cpu")
    assert pred.compute_dtype == torch.bfloat16
    leaves = weights.plan(
        pred.bundle.module,
        tiny.config("depth_anything_v2_large")["positive_weights"])
    weights.load(pred.bundle.module, weights.make(leaves, 5, "cpu"))
    prog = [pred.predict_finalized(p.astype(np.float32) / 255.0, 70, 70)
            for p in photos]
    cell = tiny.cell("t", "depth_anything_v2_large", {"net": [70, 70]}, {})
    ref = compare.reference_maps(cell, leaves, 5, "cpu", photos, "f32")
    ctl = compare.reference_maps(cell, leaves, 5, "cpu", photos, "fp8")
    rnd = compare.reference_maps(cell, leaves, 5, "cpu", photos, "bf16")
    p = compare.depth_numbers(prog, ref, rnd)
    c = compare.depth_numbers(ctl, ref, rnd)
    assert c["depth_fit_vs_bf16"] > 3 * p["depth_fit_vs_bf16"], (p, c)
    assert p["depth_range_off"] == c["depth_range_off"] == 0


@pytest.mark.parametrize("invert", [False, True])
def test_finalize_matches_the_program(invert):
    from depthmap_tpu_torch.ops import numerics
    g = torch.Generator().manual_seed(1)
    raw = torch.randn((40, 56), generator=g) * 3.0 + 1.0
    want = numerics.finalize_i16(raw, invert=invert).numpy()
    assert np.array_equal(common.to_uint16(raw, invert), want)
    flat = torch.full((8, 8), 2.5)
    assert np.array_equal(common.to_uint16(flat),
                          numerics.finalize_i16(flat).numpy())


@pytest.mark.parametrize("divergence,balance,sharp", [
    (2.5, 0.0, True), (4.0, 0.3, True), (2.5, 0.0, False)])
def test_stereo_reference_matches_the_program(divergence, balance, sharp):
    """Both eyes and both compositions, byte for byte, on sampled rows."""
    from depthmap_tpu_torch.ops.stereo import create_stereoimages
    spec = {"width": 160, "height": 48, "shapes": 4, "texture": 18.0,
            "noise": 4.0}
    img = images.photo_pool(spec, 1, 9, "cpu")[0]
    depth = images.photo_pool(spec, 1, 10, "cpu")[0][..., 0].astype(
        np.uint16) * 257
    modes = ["left-right", "red-cyan-anaglyph"]
    fill = "polylines_sharp" if sharp else "polylines_soft"
    got = create_stereoimages(img, depth, divergence, 0.0, modes, balance,
                              1.0, fill, device="cpu")
    rows = [0, 5, 17, 47]
    eyes = stereo.eye_rows(img, depth, rows, divergence, 0.0, 1.0, balance,
                           sharp)
    for mode, out in zip(modes, got):
        want = stereo.compose(mode, eyes["left"], eyes["right"])
        assert np.array_equal(out[rows], want), mode
