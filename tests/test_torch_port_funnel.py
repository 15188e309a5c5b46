"""The port's funnel and CLI against the JAX package's, the no-JAX import
rule, and the restated copies (options, registry, custom-depthmap ingest).

Custom depthmaps go through both funnels byte-equal (depth, concat_depth,
left-right, anaglyph).  The model path injects the same small DPT-BEiT
into both funnels (f32) and holds the uint16 depth maps to I16_TOL counts.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from tests.test_torch_port_model import jax_small_module, \
    jax_small_variables, torch_small_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 forwards of the two frameworks differ at ~1e-6 relative; through the
# bicubic upsample and the per-image normalization that is a few counts of
# the 16-bit range at most
I16_TOL = 16


def _run(funnel, images, depthmaps, inp, cache=None):
    out = {}
    for idx, typ, res in funnel(None, images, depthmaps, None, inp,
                                predictor_cache=cache):
        out.setdefault(typ, []).append((idx, np.asarray(res)))
    return out


def _images(rng, shapes):
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for h, w in shapes]


@pytest.mark.parametrize("opts", [
    dict(),
    dict(output_depth_invert=True, stereo_balance=0.3,
         stereo_fill_algo="polylines_soft"),
    dict(output_depth_combine=True, stereo_modes=["top-bottom",
                                                  "cyan-red-reverseanaglyph"]),
], ids=["default", "invert_soft_balance", "concat"])
def test_custom_depthmap_byte_equal(rng, opts):
    imgs = _images(rng, [(20, 36), (20, 36), (18, 30)])
    dm8 = Image.fromarray((rng.random((20, 36)) * 255).astype(np.uint8))
    dm16 = Image.fromarray((rng.random((10, 18)) * 65535).astype(np.uint16))
    dmf = rng.random((18, 30))
    base = dict(compute_device="CPU", gen_stereo=True, **opts)
    want = _run(jcore.core_generation_funnel, imgs, [dm8, dm16, dmf],
                JOptions(**base))
    got = _run(tcore.core_generation_funnel, imgs, [dm8, dm16, dmf],
               TOptions(**base))
    assert set(got) == set(want) and len(got) >= 3
    for typ in want:
        assert [i for i, _ in got[typ]] == [i for i, _ in want[typ]]
        for (_, g), (_, w) in zip(got[typ], want[typ]):
            assert g.dtype == w.dtype and g.shape == w.shape, typ
            np.testing.assert_array_equal(g, w, err_msg=typ)


class _FixedCache(tcore.PredictorCache):
    def __init__(self, pred):
        super().__init__()
        self.pred = pred

    def get(self, model_type, tiling_mode=False, **kw):
        return self.pred


def _predictors():
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.models.weights import state_dict_from_jax
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor as TPred
    variables = jax_small_variables(seed=21)
    jp = JPred(1, params=variables, compute_dtype="float32")
    jp.bundle = dataclasses.replace(jp.bundle, module=jax_small_module())
    tp = TPred(1, state_dict=state_dict_from_jax(variables),
               compute_dtype=torch.float32, device="cpu",
               bundle=torch_small_bundle())
    return jp, tp


def test_model_path_matches_jax(rng):
    """Two same-shape images ride the batched pre-pass, the third the
    serial path; 48x80 at net 64 runs a 2x4 grid (table resize), 40x40 the
    4x4 training window."""
    jp, tp = _predictors()

    class JCache(jcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return jp

    imgs = _images(rng, [(48, 80), (48, 80), (40, 40)])
    base = dict(compute_device="CPU", model_type=1, net_width=64,
                net_height=64, gen_stereo=True)
    want = _run(jcore.core_generation_funnel, imgs, None, JOptions(**base),
                JCache())
    got = _run(tcore.core_generation_funnel, imgs, None, TOptions(**base),
               _FixedCache(tp))
    assert set(got) == set(want) == {"depth", "left-right",
                                     "red-cyan-anaglyph"}
    for (_, g), (_, w) in zip(got["depth"], want["depth"]):
        assert g.dtype == np.uint16 and g.shape == w.shape
        assert g.max() - g.min() > 1000       # a live map
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert d.max() <= I16_TOL, d.max()
    for typ in ("left-right", "red-cyan-anaglyph"):
        for (_, g), (_, w) in zip(got[typ], want[typ]):
            assert g.shape == w.shape and g.dtype == np.uint8


def test_predict_and_depth_prediction_match_jax(rng):
    """The raw-map APIs: predict, predict_batch, and the funnel's
    depth_prediction output (f32, RTOL of the range)."""
    jp, tp = _predictors()
    imgs = _images(rng, [(48, 80), (48, 80)])
    stack = np.stack(imgs).astype(np.float32) / 255.0
    want = np.asarray(jp.predict_batch(stack, 64, 64))
    got = tp.predict_batch(stack, 64, 64)
    rng_ = np.ptp(want)
    assert rng_ > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * rng_)
    np.testing.assert_allclose(tp.predict(stack[1], 64, 64), got[1],
                               rtol=0, atol=1e-5 * rng_)

    class JCache(jcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return jp

    base = dict(compute_device="CPU", model_type=1, net_width=64,
                net_height=64, do_output_depth_prediction=True)
    jout = _run(jcore.core_generation_funnel, imgs[:1], None,
                JOptions(**base), JCache())
    tout = _run(tcore.core_generation_funnel, imgs[:1], None,
                TOptions(**base), _FixedCache(tp))
    assert set(tout) == set(jout) == {"depth_prediction", "depth"}
    np.testing.assert_allclose(tout["depth_prediction"][0][1],
                               jout["depth_prediction"][0][1], rtol=0,
                               atol=1e-3 * rng_)
    d = np.abs(tout["depth"][0][1].astype(np.int64)
               - jout["depth"][0][1].astype(np.int64))
    assert d.max() <= I16_TOL, d.max()


def test_batched_prepass_equals_serial(rng, monkeypatch):
    _, tp = _predictors()
    imgs = _images(rng, [(48, 80), (48, 80)])
    inp = TOptions(compute_device="CPU", model_type=1, net_width=64,
                   net_height=64)
    batched = _run(tcore.core_generation_funnel, imgs, None, inp,
                   _FixedCache(tp))
    monkeypatch.setattr(tcore, "FUNNEL_CHUNK", 1)
    serial = _run(tcore.core_generation_funnel, imgs, None, inp,
                  _FixedCache(tp))
    for (_, b), (_, s) in zip(batched["depth"], serial["depth"]):
        d = np.abs(b.astype(np.int64) - s.astype(np.int64))
        assert d.max() <= 2, d.max()


def test_stereo_runs_on_the_predicted_chunk(rng):
    """Stereo of the predicted photos runs on the chunk the forward left
    (one ``stereo_on_card`` span in each photo's ``stereo`` span); the
    custom-map photo takes the host route.  Both give create_stereoimages'
    bytes on the yielded photo and map."""
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.ops.stereo import create_stereoimages
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    from depthmap_tpu_torch.utils import profiling
    bundle = torch_small_bundle()
    tp = DepthPredictor(1, state_dict=init_random_(bundle.module,
                                                   3).state_dict(),
                        compute_dtype=torch.float32, device="cpu",
                        bundle=bundle)
    imgs = _images(rng, [(48, 80), (48, 80), (40, 40)])
    modes = ["left-right", "red-cyan-anaglyph", "left-only"]
    inp = TOptions(compute_device="CPU", model_type=1, net_width=64,
                   net_height=64, gen_stereo=True, stereo_modes=modes,
                   stereo_balance=0.2)
    profiling.reset()
    got = _run(tcore.core_generation_funnel, imgs, [None, None,
                                                    rng.random((40, 40))],
               inp, _FixedCache(tp))
    spans = profiling.timings()
    assert len(spans["stereo"]) == 3 and len(spans["stereo_on_card"]) == 2
    for i, (idx, depth) in enumerate(got["depth"]):
        assert idx == i and np.ptp(depth) > 1000     # live maps
        want = create_stereoimages(imgs[i], depth, inp.stereo_divergence,
                                   0.0, modes, 0.2, 1.0, inp.stereo_fill_algo,
                                   device="cpu")
        for mode, wnt in zip(modes, want):
            assert got[mode][i][0] == i
            np.testing.assert_array_equal(got[mode][i][1], wnt,
                                          err_msg=mode)


def test_gpu_device_needs_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA error path")
    imgs = _images(rng, [(16, 16)])
    with pytest.raises(RuntimeError, match="CUDA"):
        list(tcore.core_generation_funnel(None, imgs, None, None,
                                          TOptions(model_type=1)))


def test_unported_options_raise(rng, tmp_path, monkeypatch, capsys):
    """No option is left unported (the _NOT_PORTED table is gone).
    Background removal without rembg prints and skips, as the JAX funnel
    does (with a fake rembg: tests/test_torch_port_rembg.py); the
    inpainted mesh: with seeded checkpoints under ./models/3dphoto the
    funnel yields the OBJ's path after the depth.  Boost and Marigold
    (type 10): Boost on a custom depth map makes no prediction, as in the
    JAX funnel, and build_model(10) builds the pipeline (on the meta
    device here)."""
    from depthmap_tpu_torch.models.weights import \
        save_random_inpaint_checkpoints
    from depthmap_tpu_torch.pipeline import rembg_integration
    imgs = _images(rng, [(16, 16)])
    dm = [rng.random((16, 16))]
    monkeypatch.setattr(rembg_integration, "rembg_available", lambda: False)
    out = list(tcore.core_generation_funnel(
        None, imgs, dm, None, TOptions(compute_device="CPU", gen_rembg=True)))
    assert [t for _, t, _ in out] == ["depth"]
    assert "rembg is not installed" in capsys.readouterr().out
    assert not hasattr(tcore, "_NOT_PORTED")
    save_random_inpaint_checkpoints(str(tmp_path / "models" / "3dphoto"))
    monkeypatch.chdir(tmp_path)
    out = list(tcore.core_generation_funnel(
        str(tmp_path / "out"), imgs, dm, ["img.png"],
        TOptions(compute_device="CPU", gen_inpainted_mesh=True)))
    assert [(i, t) for i, t, _ in out] == [(0, "depth"),
                                           (0, "inpainted_mesh")]
    assert out[1][2] == str(tmp_path / "out" / "img-0000.obj")
    with open(out[1][2]) as f:
        assert sum(1 for line in f if line.startswith("v ")) >= 16 * 16
    plain = list(tcore.core_generation_funnel(
        None, imgs, dm, None, TOptions(compute_device="CPU")))
    boosted = list(tcore.core_generation_funnel(
        None, imgs, dm, None, TOptions(compute_device="CPU", boost=True)))
    assert [t for _, t, _ in boosted] == [t for _, t, _ in plain]
    np.testing.assert_array_equal(boosted[0][2], plain[0][2])
    from depthmap_tpu_torch.models import build
    from depthmap_tpu_torch.models.marigold.pipeline import MarigoldPipeline
    assert not hasattr(build, "_ROADMAP")
    with torch.device("meta"):
        assert isinstance(build.build_model(10).module, MarigoldPipeline)


def test_cli_depthmap_stereo(rng, tmp_path):
    img = tmp_path / "img.png"
    dm = tmp_path / "dm.png"
    Image.fromarray(_images(rng, [(16, 24)])[0]).save(img)
    Image.fromarray((rng.random((16, 24)) * 255).astype(np.uint8)).save(dm)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "depthmap_tpu_torch.cli", str(img),
         "--depthmap", str(dm), "--stereo", "--compute-device", "CPU",
         "-o", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    files = sorted(os.listdir(out))
    assert len(files) == 3, files
    depth = [f for f in files if f.endswith("-depth.png")]
    sbs = [f for f in files if f.endswith("-left-right.png")]
    assert depth and sbs and any("anaglyph" in f for f in files)
    d16 = np.asarray(Image.open(out / depth[0]))
    assert d16.shape == (16, 24) and d16.dtype == np.uint16
    assert np.asarray(Image.open(out / sbs[0])).shape == (16, 48, 3)


def test_port_imports_no_jax():
    """Every module of the package (walked, so the model modules that
    build_model loads lazily count too, and the frontends, rembg's
    integration, utils/, the host kernel's build, parallel/ and the graft
    entry) and chip_smoke.py (imported as a
    module, its main not run) import no JAX and nothing of the JAX
    package."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import depthmap_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'depthmap_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'depthmap_tpu_torch.models.efficientnet' in sys.modules\n"
        "for new in ('frontends.api', 'frontends.gradio_ui', "
        "'frontends.webui_script', 'pipeline.rembg_integration', "
        "'utils.download', 'utils.metrics', 'utils.profiling', "
        "'ops.host_build', '__main__', 'parallel.mesh', 'parallel.train', "
        "'graft_entry'):\n"
        "    assert 'depthmap_tpu_torch.' + new in names, new\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "assert callable(smoke.main)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'depthmap_tpu')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_restated_options_equal():
    jf = {f.name: f for f in dataclasses.fields(JOptions)}
    tf = {f.name: f for f in dataclasses.fields(TOptions)}
    assert list(jf) == list(tf)
    assert JOptions().to_dict() == TOptions().to_dict()
    d = {"MODEL_TYPE": 1, "gen_stereo": True, "unknown_key": 3}
    assert JOptions.from_dict(d).to_dict() == TOptions.from_dict(d).to_dict()


def test_restated_registry_equal():
    from depthmap_tpu import registry as jr
    from depthmap_tpu_torch import registry as tr
    assert [dataclasses.astuple(s) for s in jr._SPECS] == \
        [dataclasses.astuple(s) for s in tr._SPECS]
    for s in jr._SPECS:
        for key in (s.id, s.name, s.ui_name, str(s.id)):
            assert tr.resolve_model_type(key) == jr.resolve_model_type(key)
        assert tr.get_default_net_size(s.id) == jr.get_default_net_size(s.id)


def test_restated_ingest_equal(rng):
    cases = [
        Image.fromarray((rng.random((12, 20)) * 255).astype(np.uint8)),
        Image.fromarray((rng.random((6, 10)) * 65535).astype(np.uint16)),
        Image.fromarray((rng.random((12, 20, 3)) * 255).astype(np.uint8)),
        rng.random((12, 20)),
    ]
    for dp in cases:
        np.testing.assert_array_equal(
            tcore.ingest_custom_depthmap(dp, 20, 12),
            jcore._ingest_custom_depthmap(dp, 20, 12))
