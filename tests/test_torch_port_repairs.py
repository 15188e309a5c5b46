"""The port's funnel: its chunk plan and its out-of-memory advice.

The funnel groups the photos it predicts by shape, in input order, into
runs of FUNNEL_CHUNK (custom depth maps and the raw map's host paths
stay out), and makes each chunk when its loop first reaches one of its
photos: the outputs come in input order, byte-equal to one photo at a
time, and a chunk's maps are yielded before the next chunk's forward.
An out-of-memory error (torch.OutOfMemoryError, or any error whose text
holds "out of memory") re-raises as an Exception carrying the JAX funnel's
advice, chained to the original, for a chunk of one and of two.
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


def _unit(imgs) -> np.ndarray:
    """A predictor's input in [0, 1]: uint8 photos divided by 255 as the
    host divides them."""
    imgs = np.asarray(imgs)
    return imgs.astype(np.float32) / 255.0 if imgs.dtype == np.uint8 \
        else imgs


class _Counting:
    """A predictor that maps the red channel to depth (each map depends on
    its photo alone) and records each forward's photos by their green
    byte at (0, 0), which the tests set to the photo's index."""
    raw_prediction_invert = False

    def __init__(self):
        self.forwards = []

    def finalized_batch(self, imgs, net_w, net_h, **kw):
        self.forwards.append([int(p[0, 0, 1]) for p in imgs])
        return torch.from_numpy(
            (_unit(imgs)[..., 0] * 65535).astype(np.uint16))


def _tagged(rng, shapes):
    """uint8 photos of ``shapes``, photo i's green byte at (0, 0) set to
    i."""
    imgs = _images(rng, shapes)
    for i, im in enumerate(imgs):
        im[0, 0, 1] = i
    return imgs


def test_chunks_are_by_shape_runs_in_input_order(rng, monkeypatch):
    """Two shapes interleaved, a third alone and a custom depth map among
    them, chunks of 2: one forward per by-shape run, in the order the loop
    reaches each run's first photo; the outputs in input order, each
    byte-equal to the map the predictor gives its photo alone."""
    monkeypatch.setattr(tcore, "FUNNEL_CHUNK", 2)
    a, b, c = (20, 30), (16, 24), (12, 12)
    imgs = _tagged(rng, [a, b, a, a, b, a, b, a, c])
    dms = [None] * len(imgs)
    dms[3] = rng.random(a)
    pred = _Counting()
    out = _run(tcore.core_generation_funnel, imgs, dms,
               TOptions(compute_device="CPU"), _FixedCache(pred))
    # shape a: 0, 2, 5, 7 (3 has its own map); b: 1, 4, 6; c: 8
    assert pred.forwards == [[0, 2], [1, 4], [5, 7], [6], [8]]
    assert [i for i, _ in out["depth"]] == list(range(len(imgs)))
    alone = _Counting()
    for i, got in out["depth"]:
        want = tcore._convert_to_i16_host(dms[i]) if i == 3 else \
            alone.finalized_batch([imgs[i]], 0, 0)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(i))


def test_a_chunk_is_made_when_the_loop_reaches_it(rng):
    """17 same-shape photos: FUNNEL_CHUNK's chunks, and when photo i's
    output is yielded only the forwards of the chunks up to its own have
    run, so at most one chunk's maps wait."""
    n = 2 * tcore.FUNNEL_CHUNK + 1
    imgs = _tagged(rng, [(8, 12)] * n)
    pred = _Counting()
    ran = []
    for i, typ, _ in tcore.core_generation_funnel(
            None, imgs, None, None, TOptions(compute_device="CPU"),
            predictor_cache=_FixedCache(pred)):
        assert typ == "depth"
        ran.append((i, len(pred.forwards)))
    assert ran == [(i, i // tcore.FUNNEL_CHUNK + 1) for i in range(n)]
    assert [len(f) for f in pred.forwards] == \
        [tcore.FUNNEL_CHUNK, tcore.FUNNEL_CHUNK, 1]
    assert [i for f in pred.forwards for i in f] == list(range(n))


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
