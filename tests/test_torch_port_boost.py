"""The port's Boost (``depthmap_tpu_torch/pipeline/boost.py``, the merge
net of ``models/pix2pix.py``, the resamplers of ``ops/resize.py``) against
the JAX package's, on the same inputs and weights.

Tolerances: the host selection (R_x, patch scale, the rect list) exactly
equal; the cv2 restatements against cv2 to the last bits of f64 (the
linear resize) or 1e-6 (the float32 cubic one, a few ulps) and exactly
(dilation); the device chain (crop-resize, blend, fit, min-max) and
pix2pix in f32 at 1e-5; the blend mask at 1e-5 (the port blurs the box's
two profiles in f64, cv2 the 3000^2 image in f32); ``BoostEngine.estimate``
end to end (small models at receptive field 64, pix2pix at 6 levels and
64^2 in both packages, f32) at 2e-4 of the map's range; the funnel's uint16
map against the engine's map exactly.
"""
from __future__ import annotations

import inspect

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import pix2pix as jpix
from depthmap_tpu.pipeline import boost as JB
from depthmap_tpu_torch.models import pix2pix as tpix
from depthmap_tpu_torch.models.weights import state_dict_from_jax_pix2pix
from depthmap_tpu_torch.ops import resize as R
from depthmap_tpu_torch.pipeline import boost as TB
from tests.test_torch_port_leres import small_resnext  # noqa: F401
from tests.test_torch_port_midas import _draw
from tests.test_torch_port_midas import small_encoders  # noqa: F401

CHAIN_ATOL = 1e-5
E2E_RTOL = 2e-4


def scene(seed: int, h: int, w: int) -> np.ndarray:
    """A float RGB image in [0, 1]: smooth shading, a few textured boxes
    (where the selection puts patches) and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = 0.5 + 0.2 * np.stack([np.sin(5 * xx + c) * np.cos(3 * yy - c)
                                for c in (0.0, 1.0, 2.0)], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, h * 3 // 4), rng.integers(0, w * 3 // 4)
        bh, bw = rng.integers(h // 10, h // 4), rng.integers(w // 10, w // 4)
        f = rng.uniform(0.3, 1.5)
        img[y0:y0 + bh, x0:x0 + bw] += 0.25 * np.sin(
            f * np.arange(bw))[None, :, None] * np.cos(
                f * np.arange(bh))[:, None, None]
    img += 0.02 * rng.normal(size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


# -- host selection -------------------------------------------------------

def test_cv2_restatements_match_cv2():
    rng = np.random.default_rng(0)
    for (h, w), (oh, ow) in [((30, 47), (30, 30)), ((97, 64), (64, 64)),
                             ((40, 40), (13, 13)), ((10, 10), (37, 37)),
                             ((13, 17), (52, 52))]:
        g = rng.random((h, w))
        np.testing.assert_allclose(R.cv2_resize_linear(g, (ow, oh)),
                                   cv2.resize(g, (ow, oh)), rtol=0,
                                   atol=1e-13)
        b = (rng.random((h, w)) > 0.5).astype(np.float64)
        np.testing.assert_array_equal(
            R.cv2_resize_linear(b, (ow, oh)) >= 0.5,
            cv2.resize(b, (ow, oh)) >= 0.5)
    for (h, w), (oh, ow) in [((96, 128), (384, 512)), ((120, 90), (75, 60)),
                             ((64, 48), (37, 28))]:
        im = rng.random((h, w, 3)).astype(np.float32)
        for x in (im, im[..., 0].copy()):
            np.testing.assert_allclose(
                R.cv2_resize_cubic(x, (ow, oh)),
                cv2.resize(x, (ow, oh), interpolation=cv2.INTER_CUBIC),
                rtol=0, atol=1e-6)
    for k in (0, 3, 4, 12, 14, 16):
        x = (rng.random((33, 29)) > 0.9).astype(np.float64)
        kernel = np.ones((k, k), float)
        np.testing.assert_array_equal(R.cv2_dilate(x, k),
                                      cv2.dilate(x, kernel, iterations=1))


def test_generate_mask_matches_jax():
    want = JB.generate_mask((3000, 3000))
    got = TB.generate_mask((3000, 3000)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)


def jax_selection(img: np.ndarray, rf: int, thr: int):
    """R_x, patch scale and rects exactly as JAX's BoostEngine.estimate
    computes them (boost.py:414-459)."""
    h, w = img.shape[:2]
    size, patch_scale = JB.calculate_processing_res(img, rf, 0.2, 3, thr)
    size = min(int(-(-size // rf) * rf), int(min(thr, 3 * max(h, w))))
    factor = max(min(1.0, 4 * patch_scale * size / thr), 0.2)
    if h > w:
        a, b = 2 * size, round(2 * size * w / h)
    else:
        a, b = round(2 * size * h / w), 2 * size
    b, a = int(round(b / factor)), int(round(a / factor))
    big = cv2.resize(img, (b, a), interpolation=cv2.INTER_CUBIC)
    sy, sx = h / big.shape[0], w / big.shape[1]
    rects = []
    for p in JB.generate_patches(big, rf * 2, factor):
        r = p["rect"]
        rect = (int(round(r[0] * sx)), int(round(r[1] * sy)),
                int(round(r[2] * sx)), int(round(r[3] * sy)))
        if rect[2] > 0 and rect[3] > 0:
            rects.append(rect)
    return size, patch_scale, rects


@pytest.mark.parametrize("seed,hw,rf", [(1, (240, 360), 448),
                                        (2, (360, 240), 512),
                                        (3, (300, 400), 384),
                                        (4, (96, 128), 64)])
def test_selection_matches_jax_exactly(seed, hw, rf):
    """Landscape, portrait and 4:3 images: R_x, the patch scale and every
    rect equal (the cv2 resizes feed thresholds)."""
    img = scene(seed, *hw)
    size, scale, rects = jax_selection(img, rf, 1600)
    got_size, got_scale = TB.select_whole_size(img, rf, 1600)
    assert (got_size, got_scale) == (size, scale)
    assert TB.select_patches(img, rf, size, scale, 1600) == rects
    assert len(rects) > 0


# -- the device chain -----------------------------------------------------

def _rects(rng, h, w, n):
    r = np.stack([rng.integers(0, w // 2, n), rng.integers(0, h // 2, n),
                  rng.integers(1, w // 2, n), rng.integers(1, h // 2, n)],
                 1).astype(np.int32)
    r[-1] = 0      # a padded row
    return r


@pytest.mark.parametrize("out", [64, 100, 448])
def test_crop_resize_matches_jax(out):
    rng = np.random.default_rng(out)
    img = rng.random((97, 131, 3)).astype(np.float32)
    frame = rng.random((97, 131)).astype(np.float32)
    rects = _rects(rng, 97, 131, 6)
    for src in (img, frame):
        want = np.asarray(JB._crop_resize_batch(src, rects, out, out,
                                                "cubic"))
        got = TB.crop_resize_batch(torch.from_numpy(src), rects, out,
                                   out).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)


def test_blend_fit_minmax_match_jax():
    """The sequential blend (cubic patches, the linear 3000^2 mask) over
    rects that overlap, touch the border and include padded zero rows; the
    polyfit and the min-max normalization (one constant sample)."""
    rng = np.random.default_rng(7)
    h, w, p = 90, 120, 64
    updated = rng.random((h, w)).astype(np.float32)
    merged = rng.random((5, p, p)).astype(np.float32)
    rects = np.array([[0, 0, 120, 90], [10, 5, 60, 60], [70, 40, 50, 50],
                      [33, 17, 21, 21], [0, 0, 0, 0]], np.int32)
    mask = JB.generate_mask((3000, 3000))
    want = np.asarray(JB._blend_patches(updated, merged, rects, mask))
    got = TB.blend_patches(torch.from_numpy(updated),
                           torch.from_numpy(merged), rects,
                           torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)
    base = rng.random((4, p, p)).astype(np.float32)
    mapped = (0.3 * base + 0.1 * rng.random((4, p, p))).astype(np.float32)
    np.testing.assert_allclose(
        TB.fit_to_base(torch.from_numpy(mapped), torch.from_numpy(base)),
        np.asarray(JB._fit_to_base(mapped, base)), rtol=0, atol=CHAIN_ATOL)
    x = rng.random((3, p, p)).astype(np.float32)
    x[1] = 0.5
    np.testing.assert_allclose(
        TB.minmax_norm_batch(torch.from_numpy(x)),
        np.asarray(JB._minmax_norm_batch(x)), rtol=0, atol=CHAIN_ATOL)


# -- pix2pix --------------------------------------------------------------

def jax_pix2pix(seed: int, num_downs: int = 6, ngf: int = 8, size: int = 64):
    m = jpix.Pix2Pix4Depth(num_downs=num_downs, ngf=ngf)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size)),
                            jnp.zeros((1, size, size)))
    return m, _draw(shapes, seed)


def torch_pix2pix(variables, num_downs: int = 6, ngf: int = 8):
    net = tpix.Pix2Pix4Depth(num_downs=num_downs, ngf=ngf).eval()
    net.load_state_dict(state_dict_from_jax_pix2pix(variables), strict=True)
    return net


def test_pix2pix_small_matches_jax():
    jm, v = jax_pix2pix(3)
    net = torch_pix2pix(v)
    rng = np.random.default_rng(0)
    a = rng.random((2, 64, 64)).astype(np.float32)
    b = (3 * rng.random((2, 64, 64)) - 1).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)


def test_pix2pix_full_width_keys_match_converter():
    """The 10-level, ngf-64 net's keys are latest_net_G.pth's: every key
    convert_pix2pix reads, plus the BatchNorms' num_batches_tracked."""
    from depthmap_tpu.models.convert import SDict, convert_pix2pix
    with torch.device("meta"):
        net = tpix.build_pix2pix()
    sd = net.state_dict()
    conv = SDict({k: np.zeros(t.shape, np.float32) for k, t in sd.items()})
    convert_pix2pix(conv)
    tracked = {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(sd) - tracked == conv.used
    assert len(tracked) == 2 * 10 - 3


def test_pix2pix_tree_is_not_taken_for_another():
    from depthmap_tpu_torch.models.weights import state_dict_from_jax
    _, v = jax_pix2pix(1)
    with pytest.raises(ValueError, match="pix2pix"):
        state_dict_from_jax(v)


# -- BoostEngine end to end ----------------------------------------------

def patch_small_boost(monkeypatch):
    """PIX2PIX_SIZE 64 and a 6-level merge net in both packages (neither
    edited).  JAX's ``BoostEngine._shard_rects`` is made a staticmethod
    again where it is not: ``__graft_entry__._dryrun_inference_shards``
    (run in-process by tests/test_parallel.py) puts the bare function back
    after patching it, and a later estimate in the same process would pass
    it ``self``."""
    monkeypatch.setattr(JB, "PIX2PIX_SIZE", 64)
    monkeypatch.setattr(TB, "PIX2PIX_SIZE", 64)
    monkeypatch.setattr(jpix, "build_pix2pix",
                        lambda: jpix.Pix2Pix4Depth(num_downs=6, ngf=8))
    monkeypatch.setattr(tpix, "build_pix2pix",
                        lambda: tpix.Pix2Pix4Depth(num_downs=6, ngf=8).eval())
    shard = inspect.getattr_static(JB.BoostEngine, "_shard_rects")
    if not isinstance(shard, staticmethod):
        monkeypatch.setattr(JB.BoostEngine, "_shard_rects",
                            staticmethod(shard))


@pytest.fixture
def small_boost(monkeypatch):
    """``patch_small_boost``; JAX's jitted upsample traced afresh."""
    patch_small_boost(monkeypatch)
    JB._upsample_p_jit.clear_cache()
    yield
    JB._upsample_p_jit.clear_cache()


def engines(jp, tp, seed=5):
    """The JAX and the port engines on the same merge-net weights, at
    receptive field 64."""
    _, v = jax_pix2pix(seed)
    je = JB.BoostEngine(jp, pix2pix_variables=v)
    te = TB.BoostEngine(tp, merge_net=torch_pix2pix(v))
    je.rf = te.rf = 64
    return je, te


def assert_boost_close(got, want):
    span = float(want.max() - want.min())
    assert span > 0 and got.shape == want.shape
    assert np.abs(got - want).max() <= E2E_RTOL * span, \
        np.abs(got - want).max() / span


@pytest.mark.parametrize("mt", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13,
                                14])
def test_boost_preprocess_matches_jax(mt):
    """What Boost feeds each net (the bundle's ``boost_preprocess``, else
    its ``preprocess``) is the JAX engine's ``_boost_cfg``: the model's own
    preprocess, with ImageNet statistics and upper_bound resizing for the
    MiDaS family (types 1-6)."""
    import dataclasses
    from depthmap_tpu.models.build import build_model as j_build
    from depthmap_tpu.pipeline.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from depthmap_tpu_torch.models.build import build_model
    want = j_build(mt).preprocess
    if mt in range(1, 7):
        want = dataclasses.replace(want, mean=IMAGENET_MEAN,
                                   std=IMAGENET_STD,
                                   resize_mode="upper_bound")
    with torch.device("meta"):
        tb = build_model(mt)
    got = tb.boost_preprocess or tb.preprocess
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_host_pipeline_known_before_building():
    """``is_host_pipeline`` (what the funnel and the cache read) agrees
    with each bundle's ``host_pipeline`` (what the predictor and Boost
    read); Marigold alone is one."""
    from depthmap_tpu_torch.models.build import build_model, is_host_pipeline
    for mt in range(15):
        with torch.device("meta"):
            flag = build_model(mt).host_pipeline
        assert flag == is_host_pipeline(mt) == (mt == 10), mt


@pytest.mark.parametrize("mt", [2, 0, 7])
def test_estimate_matches_jax(small_boost, small_encoders, small_resnext, mt):
    """One model per route: type 2 (the ImageNet quirk of types 1-6), 0
    (its own preprocess, as 11-14), 7 (ZoeDepth, the prep_in_model
    route); Marigold's in tests/test_torch_port_marigold.py."""
    from tests.test_torch_port_zoo_funnel import _predictors
    jp, tp = _predictors(mt, seed=40 + mt)
    je, te = engines(jp, tp)
    img = scene(10 + mt, 96, 128)
    want = je.estimate(img, whole_size_threshold=256)
    got = te.estimate(img, whole_size_threshold=256)
    assert len(jax_selection(img, 64, 256)[2]) >= 4   # a full chunk
    assert_boost_close(got, want)


def test_double_estimate_matches_jax(small_boost, small_encoders):
    from tests.test_torch_port_zoo_funnel import _predictors
    jp, tp = _predictors(2, seed=44)
    je, te = engines(jp, tp)
    img = scene(12, 80, 112)
    assert_boost_close(te.double_estimate(img, 64, 192),
                       je.double_estimate(img, 64, 192))


def test_funnel_boost_weights_rule(small_boost, small_encoders, monkeypatch,
                                   tmp_path):
    """Without latest_net_G.pth and without the switch the funnel raises
    FileNotFoundError naming the file; with DEPTHMAP_ALLOW_RANDOM_PIX2PIX=1
    its depth map is the engine's (seeded random merge net) finalized."""
    from depthmap_tpu_torch.ops import numerics
    from depthmap_tpu_torch.options import GenerationOptions
    from depthmap_tpu_torch.pipeline import core as tcore
    from tests.test_torch_port_zoo_funnel import _predictors
    _, tp = _predictors(2, seed=45)

    class Cache(tcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return tp

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DEPTHMAP_ALLOW_RANDOM_PIX2PIX", raising=False)
    img = (scene(13, 80, 112) * 255).astype(np.uint8)
    inp = GenerationOptions(compute_device="CPU", model_type=2, boost=True)
    ops = {"boost_rmax": 256}
    with pytest.raises(FileNotFoundError, match="latest_net_G.pth"):
        list(tcore.core_generation_funnel(None, [img], None, None, inp, ops,
                                          Cache()))
    monkeypatch.setenv("DEPTHMAP_ALLOW_RANDOM_PIX2PIX", "1")
    cache = Cache()
    out = list(tcore.core_generation_funnel(None, [img, img], None, None,
                                            inp, ops, cache))
    assert [typ for _, typ, _ in out] == ["depth", "depth"]
    raw = TB.BoostEngine(tp).estimate(img.astype(np.float32) / 255.0, 256)
    want = numerics.finalize_i16(torch.from_numpy(raw), invert=False).numpy()
    for _, _, got in out:
        np.testing.assert_array_equal(got, want)
    assert cache._boost is not None
    cache.release()
    assert cache._boost is None
