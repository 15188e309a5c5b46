"""depthmap_tpu_torch numerics, resize and preprocess against the JAX
package on the same numpy inputs.

numerics: byte-exact.  resize: 1e-5 absolute on O(1) data (both are torch's
tap semantics in f32; the JAX taps are computed in f64 and rounded, torch's
in f32).  preprocess: 2e-5 absolute against cv2's INTER_CUBIC (the same
a = -0.75 kernel; cv2 rounds its tap weights differently).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.ops import numerics as jnum
from depthmap_tpu.ops.resize import interpolate as j_interpolate
from depthmap_tpu.pipeline import preprocess as jpre
from depthmap_tpu_torch.ops import numerics as tnum
from depthmap_tpu_torch.ops.resize import interpolate as t_interpolate
from depthmap_tpu_torch.pipeline import preprocess as tpre


def _maps(rng):
    raw = rng.normal(size=(24, 40)).astype(np.float32) * 7.0 + 3.0
    edge = np.linspace(-0.01, 1.01, 24 * 40, dtype=np.float32).reshape(24, 40)
    return raw, edge


def test_convert_to_i16_byte_exact(rng):
    _, edge = _maps(rng)
    vals = np.concatenate([edge.ravel(), np.float32([0, 1, 1 - 1e-7, 0.5,
                                                     1.5, -3.0])])
    want = np.asarray(jnum.convert_to_i16(jnp.asarray(vals)))
    got = tnum.convert_to_i16(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(invert=True),
    dict(clip=True, clip_mode="Range", clip_far=0.2, clip_near=0.7),
    dict(clip=True, clip_mode="Outliers", clip_far=0.05, clip_near=0.9),
    dict(clip=True, clip_mode="Outliers", clip_far=0.0, clip_near=1.0,
         invert=True),
], ids=["plain", "invert", "range", "outliers", "outliers_full_invert"])
def test_finalize_depth_byte_exact(rng, kw):
    raw, _ = _maps(rng)
    want = np.asarray(jnum.finalize_depth(jnp.asarray(raw), **kw))
    got = tnum.finalize_depth(torch.from_numpy(raw), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    want16 = np.asarray(jnum.convert_to_i16(jnp.clip(jnp.asarray(want), 0, 1)))
    got16 = tnum.finalize_i16(torch.from_numpy(raw), **kw).numpy()
    np.testing.assert_array_equal(got16, want16)


def test_constant_map_blackout():
    flat = np.full((8, 12), 3.25, np.float32)
    want = np.asarray(jnum.finalize_depth(jnp.asarray(flat)))
    got = tnum.finalize_depth(torch.from_numpy(flat)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_batched_finalize_per_frame(rng):
    """A stack finalizes each frame against its own range: equal to the
    JAX numerics applied frame by frame (a constant frame included)."""
    raws = np.stack([rng.normal(size=(10, 14)) * s + o for s, o in
                     ((1, 0), (50, 9), (0, 4))]).astype(np.float32)
    for clip, mode in ((False, "Range"), (True, "Range"),
                       (True, "Outliers")):
        kw = dict(clip=clip, clip_mode=mode, clip_far=0.1, clip_near=0.8)
        want = np.stack([np.asarray(jnum.convert_to_i16(jnp.clip(
            jnum.finalize_depth(jnp.asarray(r), **kw), 0, 1)))
            for r in raws])
        got = tnum.finalize_i16(torch.from_numpy(raws), **kw).numpy()
        np.testing.assert_array_equal(got, want)


def test_invert_and_rgb_byte_exact(rng):
    img = rng.integers(0, 65536, size=(9, 13)).astype(np.uint16)
    np.testing.assert_array_equal(
        tnum.invert_i16(torch.from_numpy(img)).numpy(),
        np.asarray(jnum.invert_i16(jnp.asarray(img))))
    np.testing.assert_array_equal(
        tnum.convert_i16_to_rgb(torch.from_numpy(img)).numpy(),
        np.asarray(jnum.convert_i16_to_rgb(jnp.asarray(img))))


@pytest.mark.parametrize("mode,align", [("bilinear", True),
                                        ("bilinear", False),
                                        ("bicubic", False)])
@pytest.mark.parametrize("size", [(23, 37), (7, 5), (16, 16)])
def test_interpolate_matches_jax(rng, mode, align, size):
    x = rng.normal(size=(2, 11, 16, 3)).astype(np.float32)
    want = np.asarray(j_interpolate(jnp.asarray(x), size, mode, align))
    got = t_interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size, mode,
                        align).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,net", [((48, 80), (64, 64)),
                                       ((64, 64), (64, 64)),
                                       ((37, 53), (96, 64)),
                                       ((1080, 1920), (512, 512))])
def test_resize_get_size_restated(in_hw, net):
    for mode in ("lower_bound", "upper_bound", "minimal"):
        for mult in (1, 14, 32):
            assert tpre.resize_get_size(in_hw[1], in_hw[0], *net, mode, True,
                                        mult) == \
                jpre.resize_get_size(in_hw[1], in_hw[0], *net, mode, True,
                                     mult)


@pytest.mark.parametrize("in_hw", [(48, 80), (64, 64), (37, 53)])
def test_preprocess_matches_jax(rng, in_hw):
    img = rng.random((*in_hw, 3)).astype(np.float32)
    cfg_j = jpre.PreprocessCfg(resize_mode="minimal", mean=jpre.HALF_MEAN,
                               std=jpre.HALF_STD, swap_channels=True)
    cfg_t = tpre.PreprocessCfg(resize_mode="minimal", mean=tpre.HALF_MEAN,
                               std=tpre.HALF_STD, swap_channels=True)
    want = jpre.preprocess_image(img, 64, 64, cfg_j)
    got = tpre.preprocess_images(torch.from_numpy(img)[None], 64, 64,
                                 cfg_t).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
