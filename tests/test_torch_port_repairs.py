"""Two repairs of the port's funnel, held to the JAX funnel.

The batched pre-pass honours DEPTHMAP_FUNNEL_BATCH_MAX_BYTES: 5 bytes a
pixel summed over the inputs, as depthmap_tpu/pipeline/core.py:230-239
sums them; above the cap no batched call is made and the outputs are the
same bytes.  An out-of-memory error (torch.OutOfMemoryError, or any error
whose text holds "out of memory") re-raises as an Exception carrying the
JAX funnel's advice, chained to the original, in the serial loop and in
the pre-pass.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from tests.test_torch_port_funnel import _FixedCache, _images, _run


class _Counting:
    """A predictor that maps the red channel to depth and counts the
    batched and the single calls."""
    raw_prediction_invert = False

    def __init__(self):
        self.batched = self.single = 0

    def finalized_batch(self, imgs01, net_w, net_h, **kw):
        self.batched += 1
        return torch.from_numpy(
            (np.asarray(imgs01)[..., 0] * 65535).astype(np.uint16))

    def predict_finalized(self, img01, net_w, net_h, **kw):
        self.single += 1
        return (np.asarray(img01)[..., 0] * 65535).astype(np.uint16)


def _capped(rng, monkeypatch, cap):
    imgs = _images(rng, [(20, 30), (20, 30), (20, 30)])
    pred = _Counting()
    if cap is not None:
        monkeypatch.setenv("DEPTHMAP_FUNNEL_BATCH_MAX_BYTES", str(cap))
    out = _run(tcore.core_generation_funnel, imgs, None,
               TOptions(compute_device="CPU", gen_stereo=True),
               _FixedCache(pred))
    return pred, out


def test_cap_skips_the_batched_prepass(rng, monkeypatch):
    total = 3 * 5 * 20 * 30     # 3 B RGB + 2 B uint16 a pixel
    free, want = _capped(np.random.default_rng(0), monkeypatch, None)
    assert (free.batched, free.single) == (1, 0)
    at_cap, got = _capped(np.random.default_rng(0), monkeypatch, total)
    assert (at_cap.batched, at_cap.single) == (1, 0)
    over, got = _capped(np.random.default_rng(0), monkeypatch, total - 1)
    assert (over.batched, over.single) == (0, 3)
    assert set(got) == set(want) == {"depth", "left-right",
                                     "red-cyan-anaglyph"}
    for typ in want:
        for (i, g), (j, w) in zip(got[typ], want[typ]):
            assert i == j
            np.testing.assert_array_equal(g, w, err_msg=typ)


def test_cap_counts_every_input_as_jax_does(rng):
    """The sum covers PIL images and arrays, custom-depth inputs too."""
    from PIL import Image
    imgs = [Image.new("RGB", (30, 20)), np.zeros((7, 9, 3), np.uint8),
            np.zeros((5, 4), np.uint8)]
    assert sum(5 * tcore._pixels(i) for i in imgs) == \
        5 * (600 + 63 + 20)


class _Oom:
    """A predictor (and Boost engine) whose every forward raises."""
    raw_prediction_invert = False
    model_type = 1

    def __init__(self, exc):
        self.exc = exc

    def _raise(self, *a, **kw):
        raise self.exc

    finalized_batch = predict_finalized = predict = estimate = _raise
    _dispatch_finalized_batch = predict_finalized_batch = _raise


class _OomCache(tcore.PredictorCache):
    def __init__(self, exc):
        super().__init__()
        self.pred = _Oom(exc)

    def get(self, *a, **kw):
        return self.pred

    def get_boost(self, *a, **kw):
        return self.pred


class _JOomCache(jcore.PredictorCache):
    def __init__(self, exc):
        super().__init__()
        self.pred = _Oom(exc)

    def get(self, *a, **kw):
        return self.pred

    def get_boost(self, *a, **kw):
        return self.pred


def _advice(funnel, cache, imgs, opts):
    with pytest.raises(Exception) as e:
        list(funnel(None, imgs, None, None, opts, predictor_cache=cache))
    return e.value


@pytest.mark.parametrize("model_type", [6, 1])
@pytest.mark.parametrize("boost", [False, True])
@pytest.mark.parametrize("n_images", [1, 2], ids=["serial", "prepass"])
def test_oom_advice_equals_jax(rng, model_type, boost, n_images):
    imgs = _images(rng, [(16, 16)] * n_images)
    opts = dict(compute_device="CPU", model_type=model_type, boost=boost)
    cause = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    got = _advice(tcore.core_generation_funnel, _OomCache(cause), imgs,
                  TOptions(**opts))
    want = _advice(jcore.core_generation_funnel, _JOomCache(cause), imgs,
                   JOptions(**opts))
    assert type(got) is Exception and str(got) == str(want)
    assert got.__cause__ is cause
    assert str(got).startswith("out of device memory")
    assert ("midas_v21_small" in str(got)) == (model_type != 6)
    assert ("Disable BOOST" in str(got)) == boost


def test_torch_oom_type_and_other_errors(rng):
    imgs = _images(rng, [(16, 16)])
    opts = TOptions(compute_device="CPU")
    oom = torch.OutOfMemoryError("allocation failed")
    got = _advice(tcore.core_generation_funnel, _OomCache(oom), imgs, opts)
    assert str(got) == tcore.oom_suggestion(opts) and got.__cause__ is oom
    other = ValueError("not a memory error")
    got = _advice(tcore.core_generation_funnel, _OomCache(other), imgs, opts)
    assert got is other
