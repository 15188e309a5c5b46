"""The port's Marigold pipeline (type 10) against the JAX package's on the
small nets of tests/test_torch_port_marigold.py, the same weights and the
same initial noise: the whole inference, DepthPredictor(10), the funnel
with its Marigold ops, the CLI, and Boost's Marigold route.

Tolerances, f32: the denoised members and every map made without the
ensemble (ensemble size 1) at 1e-4 (maps in [0, 1]), their uint16 maps to
8 counts, Boost on Marigold at 2e-4 of the range.  The ensembled map (2
members) is held through its members (1e-4) and through
``ensemble_depths`` itself (equal on equal members, test_torch_port_
marigold.py); the two ensembled maps agree only to 0.05 on average,
because the reference's BFGS takes finite-difference gradients with a step
of 1.5e-8 on f32 arithmetic, so member differences of 1e-6 already change
its scales and shifts.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import jax

from depthmap_tpu_torch.models import weights as W
from depthmap_tpu_torch.models.marigold import pipeline as tmp
from tests.test_torch_port_marigold import (_image, _nchw, _predictors,
                                            jax_noise, jax_pipeline,
                                            tiny_marigold,  # noqa: F401
                                            torch_pipeline)

MAP_ATOL = 1e-4
I16_COUNTS = 8


def test_inference_matches_jax():
    """48 x 64 members at latent 6 x 8, 2 steps; then the whole call on a
    40 x 56 image at processing_res 64 (resized to 48 x 64 and, with
    match_input_res, back), ensemble 1 and 2."""
    jpipe = jax_pipeline(seed=3)
    tpipe = torch_pipeline(jpipe.vars)
    rgb = np.stack([_image(19, 48, 64), _image(20, 48, 64)])
    want = jpipe.single_infer(rgb, 2, jax.random.split(jax.random.PRNGKey(7),
                                                       2))
    got = tpipe.single_infer(_nchw(rgb).contiguous(), 2,
                             jax_noise(2, 6, 8, 7)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)
    img = _image(20, 40, 56)
    for match in (False, True):
        want = jpipe(img, processing_res=64, ensemble_size=1,
                     denoising_steps=2, seed=5, match_input_res=match)
        got = tpipe.infer(img, processing_res=64, ensemble_size=1,
                          denoising_steps=2, match_input_res=match,
                          noise=jax_noise(1, 6, 8, 5))
        assert got.shape == want.shape == ((40, 56) if match else (48, 64))
        np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)
    want = jpipe(img, processing_res=64, ensemble_size=2, denoising_steps=2,
                 seed=5)
    noise = jax_noise(2, 6, 8, 5)
    got = tpipe.infer(img, processing_res=64, ensemble_size=2,
                      denoising_steps=2, noise=noise)
    members = tpipe.single_infer(_nchw(tmp.cv2_resize_cubic(img, (64, 48))
                                       .clip(0, 1)[None]).expand(
                                           2, -1, -1, -1), 2, noise).numpy()
    np.testing.assert_array_equal(got, tmp.ensemble_depths(members))
    assert got.shape == want.shape and got.min() == 0 and got.max() == 1
    assert np.abs(got - want).mean() < 0.05


def test_predictor_matches_jax(tiny_marigold):
    """DepthPredictor(10): predict (processing_res = net width, the map
    resized back), predict_batch (serial), predict_finalized."""
    jp, tp = _predictors(tiny_marigold, ensembles=1)
    assert (tp.compute_dtype, tp.core_dtype) == (torch.float32,) * 2
    imgs = np.stack([_image(22, 40, 56), _image(23, 40, 56)])
    want = np.stack([jp.predict(f, 64, 64) for f in imgs])
    np.testing.assert_allclose(tp.predict_batch(imgs, 64, 64), want,
                               rtol=0, atol=MAP_ATOL)
    got16 = tp.predict_finalized(imgs[0], 64, 64)
    want16 = jp.predict_finalized(imgs[0], 64, 64)
    assert got16.dtype == np.uint16 and got16.shape == (40, 56)
    assert np.abs(got16.astype(int) - want16.astype(int)).max() <= \
        I16_COUNTS


def test_funnel_and_cli(tiny_marigold, tmp_path):
    """Type 10 through the funnel (two same-shape images: the pre-pass runs
    them one at a time; its ops build the predictor) against the JAX
    funnel, and through the CLI by name."""
    from PIL import Image
    from depthmap_tpu.options import GenerationOptions as JOptions
    from depthmap_tpu.pipeline import core as jcore
    from depthmap_tpu_torch import cli
    from depthmap_tpu_torch.options import GenerationOptions as TOptions
    from depthmap_tpu_torch.pipeline import core as tcore
    imgs = [(_image(s, 40, 56) * 255).astype(np.uint8) for s in (24, 25)]
    ops = {"marigold_ensembles": 1, "marigold_steps": 2}
    base = dict(compute_device="CPU", model_type=10, net_width=64,
                net_height=64)
    want = [np.asarray(r) for _, _, r in jcore.core_generation_funnel(
        None, imgs, None, None, JOptions(**base), ops,
        jcore.PredictorCache())]   # PIL I;16 images
    sd = W.state_dict_from_jax_marigold(tiny_marigold.vars)

    class Cache(tcore.PredictorCache):     # the JAX pipeline's weights
        def get(self, model_type, tiling_mode=False, **kw):
            return super().get(model_type, tiling_mode, state_dict=sd, **kw)

    tcache = Cache()
    got = [r for _, _, r in tcore.core_generation_funnel(
        None, imgs, None, None, TOptions(**base), ops, tcache)]
    pred = tcache._predictor
    assert (pred.marigold_ensembles, pred.marigold_steps) == (1, 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == (40, 56)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= I16_COUNTS
    # the knobs enter the cache key of type 10 only
    assert tcache.get(10, device=torch.device("cpu"), marigold_ensembles=1,
                      marigold_steps=2) is pred
    path = tmp_path / "in.png"
    Image.fromarray(imgs[0]).save(path)
    out = tmp_path / "out"
    assert cli.run([str(path), "--model", "marigold_v1", "--compute-device",
                    "CPU", "--net-width", "32", "--net-height", "32",
                    "--output", str(out)]) == 0
    saved = sorted(os.listdir(out))
    assert len(saved) == 1 and saved[0].endswith("depth.png")
    d = np.asarray(Image.open(out / saved[0]))
    assert d.shape == (40, 56) and d.max() > d.min()


def test_boost_on_marigold_matches_jax(tiny_marigold, monkeypatch):
    """Boost's Marigold route (its pipeline per crop and for the whole
    image, ensemble 1) end to end against the JAX engine."""
    from depthmap_tpu.pipeline import boost as JB
    from tests.test_torch_port_boost import (assert_boost_close, engines,
                                             patch_small_boost)
    patch_small_boost(monkeypatch)
    JB._upsample_p_jit.clear_cache()
    try:
        jp, tp = _predictors(tiny_marigold, ensembles=1)
        je, te = engines(jp, tp, seed=9)
        img = _image(26, 64, 80)     # R_x 64: one whole-image program
        assert_boost_close(te.estimate(img, whole_size_threshold=64),
                           je.estimate(img, whole_size_threshold=64))
    finally:
        JB._upsample_p_jit.clear_cache()
