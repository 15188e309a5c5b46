"""The port's ZoeDepth (types 7-9) against the JAX package's, on the same
weights, and the two repairs it needs (DEPTHMAP_COMPUTE_DTYPE,
DEPTHMAP_REFERENCE_DEFAULTS).

Each metric-head piece is held to its JAX module alone; the whole models
run on the tiny core of tests/test_models_zoedepth.py (a ViT 32 wide,
depth 4, 2 heads, training grid 4, features 32) with 8 bins and 16-wide
bin embeddings, or on a tiny BEiT core for the relative-position bias.
Weights are drawn with numpy from a seed in the JAX layout and carried
into the port with ``state_dict_from_jax``.  f32 throughout; bound atol
3e-3, rtol 1e-3 (tests/test_torch_port_model.py's), also for the
log-binomial head: its softmax runs at temperatures down to 0.0212, which
scales a logit difference 47x, and the two frameworks still agree to
~1e-6 there.  The full-width modules are built on the meta device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import zoedepth as jz
from depthmap_tpu_torch.models import weights as W
from depthmap_tpu_torch.models import zoedepth as tz
from tests.test_torch_port_midas import _draw

ATOL, RTOL = 3e-3, 1e-3
VIT = dict(embed_dim=32, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
           train_grid=4)
BEIT = dict(embed_dim=32, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
            train_img_size=64, patch_size=16)
CHANNELS = (16, 32, 48, 48)
HEAD = dict(n_bins=8, bin_embedding_dim=16)
# kind -> the JAX and the port model's keyword arguments
KINDS = {"n": dict(max_depth=10.0),
         "k": dict(max_depth=80.0, bin_centers_type="normed"),
         "nk": {}}


def _core(framework: str, beit: bool = False):
    if framework == "jax":
        from depthmap_tpu.models.beit import BeitBackbone
        from depthmap_tpu.models.dpt import DPTDepthModel
        from depthmap_tpu.models.vit import VitBackbone
        bb = BeitBackbone(**BEIT) if beit else VitBackbone(**VIT)
        return DPTDepthModel(backbone=bb, reassemble_channels=CHANNELS,
                             features=32, with_zoe_taps=True)
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    from depthmap_tpu_torch.models.vit import VitBackbone
    bb = BeitBackbone(**BEIT) if beit else VitBackbone(**VIT)
    return DPTDepthModel(bb, CHANNELS, 32, with_zoe_taps=True)


def models(kind: str, beit: bool = False, img_size=(64, 64)):
    """(JAX, port) ZoeDepthInference of ``kind`` on the tiny core."""
    out = []
    for fw, mod in (("jax", jz), ("torch", tz)):
        core = _core(fw, beit)
        if kind == "nk":
            inner = mod.ZoeDepthNK(core, **HEAD)
        else:
            inner = mod.ZoeDepth(core, **HEAD, **KINDS[kind])
        out.append(mod.ZoeDepthInference(inner, img_size=img_size))
    return out


def jax_variables(jm, seed: int, hw=(64, 64)):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3)))
    return _draw(shapes, seed)


def load(tm, variables):
    tm.load_state_dict(W.state_dict_from_jax(variables), strict=True)
    return tm.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy()


# -- the head's pieces ------------------------------------------------------

def _mlp2_sd(p):
    sd = {}
    W._put_mlp2(sd, "m", p)
    return {k[2:]: v for k, v in sd.items()}


def _clb_sd(p):
    sd = {}
    W._put_conv(sd, "mlp.0", p["mlp_conv1"]["conv"])
    W._put_conv(sd, "mlp.2", p["mlp_conv2"]["conv"])
    return sd


def _router_sd(p):
    sd = {}
    W._put_patch_transformer(sd, "", p)
    return sd


def _attractor_inputs(rng, normed: bool):
    b_prev = rng.random((2, 3, 5, 8)) if normed else \
        0.5 + 3 * rng.random((2, 3, 5, 8))
    return [rng.normal(size=(2, 6, 10, 16)), b_prev,
            rng.normal(size=(2, 3, 5, 16))]


# piece -> (JAX module, port module, its state dict from the JAX params,
# inputs (NHWC) from a generator)
PIECES = {
    "seed_unnormed": (
        lambda: jz.SeedBinRegressorUnnormed(8, 12),
        lambda: tz.SeedBinRegressorUnnormed(20, 8, 12), _mlp2_sd,
        lambda r: [r.normal(size=(2, 5, 7, 20))]),
    "seed_normed": (
        lambda: jz.SeedBinRegressorNormed(8, 12, 1e-3, 80.0),
        lambda: tz.SeedBinRegressorNormed(20, 8, 12, 1e-3, 80.0), _mlp2_sd,
        lambda r: [r.normal(size=(2, 5, 7, 20))]),
    "projector": (
        lambda: jz.Projector(16, mlp_dim=24),
        lambda: tz.Projector(20, 16, 24), _mlp2_sd,
        lambda r: [r.normal(size=(2, 5, 7, 20))]),
    "attractor_unnormed": (
        lambda: jz.AttractorLayerUnnormed(4, 12, 1000.0),
        lambda: tz.AttractorLayerUnnormed(16, 4, 12, 1000.0), _mlp2_sd,
        lambda r: _attractor_inputs(r, False)),
    "attractor_normed_exp_sum": (
        lambda: jz.AttractorLayerNormed(4, 12, 1000.0, 2, "sum", "exp",
                                        1e-3, 80.0),
        lambda: tz.AttractorLayerNormed(16, 4, 12, 1000.0, 2, "sum", "exp",
                                        1e-3, 80.0), _mlp2_sd,
        lambda r: _attractor_inputs(r, True)),
    "attractor_normed_inv_mean": (
        lambda: jz.AttractorLayerNormed(4, 12, 1000.0, 2, "mean", "inv",
                                        1e-3, 80.0),
        lambda: tz.AttractorLayerNormed(16, 4, 12, 1000.0, 2, "mean", "inv",
                                        1e-3, 80.0), _mlp2_sd,
        lambda r: _attractor_inputs(r, True)),
    "log_binomial": (
        lambda: jz.ConditionalLogBinomial(64, 2, 16),
        lambda: tz.ConditionalLogBinomial(33, 16, 64, 2), _clb_sd,
        lambda r: [r.normal(size=(2, 6, 9, 33)),
                   r.normal(size=(2, 6, 9, 16))]),
    "log_binomial_nk": (
        lambda: jz.ConditionalLogBinomial(64, 4, 16),
        lambda: tz.ConditionalLogBinomial(32, 16, 64, 4), _clb_sd,
        lambda r: [r.normal(size=(2, 6, 9, 32)),
                   r.normal(size=(2, 6, 9, 16))]),
    "patch_transformer": (
        lambda: jz.PatchTransformerEncoder(),
        lambda: tz.PatchTransformerEncoder(24), _router_sd,
        lambda r: [r.normal(size=(3, 3, 5, 24))]),
}


@pytest.mark.parametrize("piece", list(PIECES))
def test_head_piece_matches_jax(piece):
    jmod, tmod, to_sd, inputs = PIECES[piece]
    rng = np.random.default_rng(7)
    args = [a.astype(np.float32) for a in inputs(rng)]
    jm = jmod()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in args])
    v = _draw(shapes, seed=8)
    want = jax.jit(jm.apply)(v, *[jnp.asarray(a) for a in args])
    tm = tmod()
    tm.load_state_dict({k: t.float() for k, t in
                        to_sd(v["params"]).items()}, strict=True)
    with torch.no_grad():
        got = tm(*[_nchw(a) if a.ndim == 4 else torch.from_numpy(a)
                   for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        g, w = _nhwc(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.isfinite(g).all() and np.ptp(w) > 0
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_log_binomial_table_and_distances():
    """The host-built table equals the JAX package's at K = 64 and 8 (no
    NaN at k = K-1); the attractor distances agree at alpha 300."""
    for k in (8, 64):
        got = tz.log_binom_table(k)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, np.asarray(jz._log_binom_table(k),
                                                      np.float32))
    dx = np.random.default_rng(9).normal(size=(4, 50)).astype(np.float32)
    for jf, tf in ((jz.inv_attractor, tz.inv_attractor),
                   (jz.exp_attractor, tz.exp_attractor)):
        np.testing.assert_allclose(tf(torch.from_numpy(dx), 300.0, 2).numpy(),
                                   np.asarray(jf(jnp.asarray(dx), 300.0, 2)),
                                   atol=1e-6, rtol=1e-5)


# -- whole models -------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax(kind):
    """ZoeDepth (softplus and normed bins) and ZoeDepthNK on a normalized
    batch, without the inference wrapper."""
    jm, tm = models(kind)
    v = jax_variables(jm, seed=10)
    x = np.random.default_rng(11).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, a: jm.model.apply(
        {"params": v["params"]["model"]}, a))(v, jnp.asarray(x)))
    load(tm, v)
    with torch.no_grad():
        got = tm.model(_nchw(x)).numpy()
    assert got.shape == want.shape == x.shape[:3]
    assert np.ptp(want) > 1e-3 and (want > 0).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_inference_matches_jax_non_square(kind):
    """ZoeDepthInference on a 50 x 70 input: reflect pad (10, 15), flip
    TTA as one batch, resize to the net input, bicubic back, crop,
    average."""
    jm, tm = models(kind)
    v = jax_variables(jm, seed=12)
    x = np.random.default_rng(13).random((2, 50, 70, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a))(v,
                                                           jnp.asarray(x)))
    load(tm, v)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 50, 70)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert tz.ZoeDepthInference.net_input_size(50, 70, None, (64, 64)) == \
        jz.ZoeDepthInference.net_input_size(50, 70, None, (64, 64))


@pytest.mark.parametrize("kind", list(KINDS))
def test_beit_core_hoisted_matches_inline(kind):
    """A tiny BEiT core (training window 4 x 4) at a 48 x 80 input: the
    hoisted biases (grid_inputs) and the inline ones give the same map,
    and both match the JAX package's."""
    jm, tm = models(kind, beit=True)
    v = jax_variables(jm, seed=14)
    x = np.random.default_rng(15).random((1, 48, 80, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    load(tm, v)
    hw = tm.net_input_size(48, 80, None, tm.img_size)
    inputs = tm.grid_inputs(hw, torch.float32)
    assert len(inputs["rel_bias"]) == BEIT["depth"]
    with torch.no_grad():
        inline = tm(_nchw(x)).numpy()
        hoisted = tm(_nchw(x), **inputs).numpy()
    np.testing.assert_allclose(hoisted, inline, atol=1e-5, rtol=0)
    np.testing.assert_allclose(hoisted, want, atol=ATOL, rtol=RTOL)


def _vote_logit(tm, x: np.ndarray) -> float:
    """The router's kitti-minus-nyu logit of each image of ``x``."""
    m = tm.model
    with torch.no_grad():
        _, _, btlnck, _, _ = m._features(_nchw(x), {})
        logits = m.mlp_classifier(m.patch_transformer(btlnck))
    return (logits[:, 1] - logits[:, 0]).numpy()


def test_nk_batch_vote_matches_jax():
    """The domain vote sums the logits over the whole batch: two images
    that vote for different experts alone share the batch's expert.  The
    classifier's bias is set so that image a votes kitti alone, image b
    nyu, and the pair kitti; the port follows the JAX package case for
    case."""
    jm, tm = models("nk")
    v = jax_variables(jm, seed=16)
    rng = np.random.default_rng(17)
    a = rng.normal(size=(1, 64, 96, 3)).astype(np.float32) + 1.5
    b = rng.normal(size=(1, 64, 96, 3)).astype(np.float32) - 1.5
    p = v["params"]["model"]["mlp_classifier_2"]
    p["bias"] = np.zeros(2, np.float32)
    load(tm, v)
    da, db = _vote_logit(tm, a)[0], _vote_logit(tm, b)[0]
    assert abs(da - db) > 1e-3
    if da < db:
        a, b, da, db = b, a, db, da
    p["bias"][1] = -(0.4 * da + 0.6 * db)     # a alone: kitti, b alone: nyu
    load(tm, v)
    pair = np.concatenate([a, b])
    assert list(_vote_logit(tm, a) > 0) == [True]
    assert list(_vote_logit(tm, b) > 0) == [False]
    assert _vote_logit(tm, pair).sum() > 0

    run = jax.jit(lambda mv, x: jm.model.apply({"params": mv}, x))

    def run_jax(x):
        return np.asarray(run(v["params"]["model"], jnp.asarray(x)))
    with torch.no_grad():
        got = {k: tm.model(_nchw(x)).numpy()
               for k, x in (("a", a), ("b", b), ("pair", pair))}
    for k, x in (("a", a), ("b", b), ("pair", pair)):
        np.testing.assert_allclose(got[k], run_jax(x), atol=ATOL, rtol=RTOL)
    # a rides its own expert in the pair, b the other one's
    np.testing.assert_allclose(got["pair"][0], got["a"][0], atol=ATOL,
                               rtol=RTOL)
    assert np.abs(got["pair"][1] - got["b"][0]).max() > 10 * ATOL


# -- predictor: precision, grid inputs, repairs ------------------------------

ENVS = [{}, {"DEPTHMAP_COMPUTE_DTYPE": "float32"},
        {"DEPTHMAP_COMPUTE_DTYPE": "bfloat16"},
        {"DEPTHMAP_ZOE_CORE_DTYPE": "float32"},
        {"DEPTHMAP_ZOE_KNK_HEAD_F32": "0"},
        {"DEPTHMAP_ZOE_KNK_HEAD_F32": "1", "DEPTHMAP_ZOE_CORE_DTYPE":
         "float32"}]


@functools.lru_cache(maxsize=None)
def _selective_core(mt: int):
    """The port's bundle's ``selective_core`` for model type ``mt``."""
    from depthmap_tpu_torch.models.build import build_model
    with torch.device("meta"):
        return build_model(mt).selective_core


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_selective_precision_table_matches_jax(monkeypatch, env):
    """(compute, core) dtypes of each type, with each variable set and
    unset and with an explicit f32 (the funnel's no_half), as the JAX
    DepthPredictor sets them (built on an empty parameter tree)."""
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.pipeline.depth import precision
    for var in ("DEPTHMAP_COMPUTE_DTYPE", "DEPTHMAP_ZOE_CORE_DTYPE",
                "DEPTHMAP_ZOE_KNK_HEAD_F32"):
        monkeypatch.delenv(var, raising=False)
    for var, val in ENVS[env].items():
        monkeypatch.setenv(var, val)
    empty = {"params": {"model": {"core": {}}}}
    for mt in (0, 1, 5, 7, 8, 9, 13):
        for explicit in (None, "float32"):
            jp = JPred(mt, params=empty, compute_dtype=explicit)
            want = (str(jp.compute_dtype), str(jp.core_dtype))
            got = tuple(str(d).split(".")[-1]
                        for d in precision(mt, explicit,
                                           _selective_core(mt)))
            assert got == want, (mt, explicit, ENVS[env])


def test_compute_dtype_env_matches_jax(monkeypatch):
    from depthmap_tpu.pipeline.depth import default_compute_dtype as jdef
    from depthmap_tpu_torch.pipeline.depth import default_compute_dtype
    for val in (None, "float32", "bfloat16"):
        if val is None:
            monkeypatch.delenv("DEPTHMAP_COMPUTE_DTYPE", raising=False)
        else:
            monkeypatch.setenv("DEPTHMAP_COMPUTE_DTYPE", val)
        for mt in (0, 1, 7):
            assert str(default_compute_dtype(mt)).split(".")[-1] == \
                str(jnp.dtype(jdef(mt)))


@pytest.mark.parametrize("value", [None, "0", "1", "true"])
def test_reference_defaults_match_jax(monkeypatch, value):
    from depthmap_tpu import registry as jr
    from depthmap_tpu_torch import registry as tr
    if value is None:
        monkeypatch.delenv("DEPTHMAP_REFERENCE_DEFAULTS", raising=False)
    else:
        monkeypatch.setenv("DEPTHMAP_REFERENCE_DEFAULTS", value)
    assert tr.reference_defaults_enabled() == jr.reference_defaults_enabled()
    for mt in jr.MODELS:
        assert tr.get_default_net_size(mt) == jr.get_default_net_size(mt)


def _predictors(kind: str, seed: int, **tkw):
    """The JAX and the port predictor of ``kind`` around the tiny BEiT
    model, on the same weights (the port's dtypes from ``tkw``)."""
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor as TPred
    mt = {"n": 7, "k": 8, "nk": 9}[kind]
    jm, tm = models(kind, beit=True)
    v = jax_variables(jm, seed)
    jp = JPred(mt, params=v, compute_dtype="float32")
    jp.bundle = dataclasses.replace(jp.bundle, module=jm)
    with torch.device("meta"):
        bundle = build_model(mt)
    tp = TPred(mt, state_dict=W.state_dict_from_jax(v), device="cpu",
               bundle=dataclasses.replace(bundle, module=tm), **tkw)
    return jp, tp


@pytest.mark.parametrize("kind", list(KINDS))
def test_predictor_matches_jax(kind, rng):
    """predict_batch at net 64 x 64 on 48 x 80 images (net input 64 x 96):
    the BGR swap, the grid inputs keyed on the net input, no upsample."""
    jp, tp = _predictors(kind, seed=18, compute_dtype=torch.float32)
    imgs = rng.random((2, 48, 80, 3)).astype(np.float32)
    want = np.asarray(jp.predict_batch(imgs, 64, 64))
    got = tp.predict_batch(imgs, 64, 64)
    assert got.shape == want.shape == (2, 48, 80)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert list(tp._grid_inputs) == [(64, 96)]
    np.testing.assert_allclose(tp.predict(imgs[1], 64, 64), got[1],
                               atol=1e-5, rtol=1e-5)


def test_selective_precision_core_bf16_head_f32(monkeypatch, rng):
    """Type 8's default: the core's weights bf16 (its last conv f32), the
    metric head's f32, the hoisted biases bf16; the map stays within 2%
    (mean relative) of the all-f32 one."""
    for var in ("DEPTHMAP_COMPUTE_DTYPE", "DEPTHMAP_ZOE_KNK_HEAD_F32"):
        monkeypatch.delenv(var, raising=False)
    _, sel = _predictors("k", seed=19)
    assert (sel.compute_dtype, sel.core_dtype) == (torch.float32,
                                                   torch.bfloat16)
    m = sel.bundle.module.model
    dpt = m.core.core
    assert dpt.pretrained.model.cls_token.dtype == torch.bfloat16
    assert dpt.scratch.output_conv[4].weight.dtype == torch.float32
    assert m.conv2.weight.dtype == torch.float32
    assert m.attractors[0]._net[0].weight.dtype == torch.float32
    imgs = rng.random((1, 48, 80, 3)).astype(np.float32)
    got = sel.predict_batch(imgs, 64, 64)
    assert all(b.dtype == torch.bfloat16
               for b in sel._grid_inputs[(64, 96)]["rel_bias"])
    _, f32 = _predictors("k", seed=19, compute_dtype="float32")
    ref = f32.predict_batch(imgs, 64, 64)
    rel = np.abs(got - ref) / np.abs(ref)
    assert 0 < rel.mean() < 0.02, rel.mean()


# -- weights ---------------------------------------------------------------

def _reference_keys(sd):
    """The wrapper's state dict in the reference checkpoint's keys (the
    model's, without the ``model.`` prefix)."""
    assert all(k.startswith("model.") for k in sd)
    return {k[len("model."):]: t for k, t in sd.items()}


def _convert(variant: str, monkeypatch, depth: int):
    """convert_zoedepth with the BEiT converter at ``depth`` blocks."""
    from depthmap_tpu.models import convert as C
    orig = C.convert_dpt_beit
    monkeypatch.setattr(C, "convert_dpt_beit",
                        lambda sd, _depth, prefix="": orig(sd, depth,
                                                            prefix))
    return lambda sd: C.convert_zoedepth(sd, variant)


@pytest.mark.parametrize("kind", list(KINDS))
def test_weights_round_trip(kind, monkeypatch):
    """convert_zoedepth(state_dict_from_jax(v)) reproduces every leaf of v
    exactly and reads every key."""
    from depthmap_tpu.models.convert import SDict
    jm, tm = models(kind, beit=True)
    v = jax_variables(jm, seed=20)
    sd = W.state_dict_from_jax(v)
    assert set(sd) == set(tm.state_dict())
    s = SDict(_reference_keys(sd))
    back = _convert(kind, monkeypatch, BEIT["depth"])(s)
    assert s.unused() == []
    flat_b = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(back)}
    flat_v = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(v)}
    assert set(flat_b) == set(flat_v)
    for k, x in flat_v.items():
        np.testing.assert_array_equal(np.asarray(flat_b[k]), x, err_msg=k)


@pytest.mark.parametrize("mt", [7, 8, 9])
def test_full_width_layout_matches_converter(mt, monkeypatch):
    """The full-width module names exactly the keys convert_zoedepth reads,
    and the converted tree has the JAX module's shapes."""
    from depthmap_tpu.models.build import build_model as j_build
    from depthmap_tpu.models.convert import SDict
    from depthmap_tpu_torch.models.build import build_model
    with torch.device("meta"):
        m = build_model(mt).module
    s = SDict({k: np.broadcast_to(np.float32(0), tuple(t.shape))
               for k, t in _reference_keys(m.state_dict()).items()})
    conv = _convert({7: "n", 8: "k", 9: "nk"}[mt], monkeypatch, 24)(s)
    assert s.unused() == []
    jshapes = jax.eval_shape(j_build(mt).module.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 64, 3)))
    got = {jax.tree_util.keystr(p): np.shape(x) for p, x in
           jax.tree_util.tree_leaves_with_path(conv)}
    want = {jax.tree_util.keystr(p): x.shape for p, x in
            jax.tree_util.tree_leaves_with_path(jshapes)}
    assert got == want


def test_strict_checkpoint_load(tmp_path):
    """A ZoeDepth checkpoint in the reference layout (under 'model', with
    the LogBinomial buffers and the timm head) loads with strict=True."""
    _, tm = models("nk", beit=True)
    src = W.init_random_(tm, seed=3)
    sd = _reference_keys(src.state_dict())
    for d in ("nyu", "kitti"):
        t = f"conditional_log_binomial.{d}.log_binomial_transform"
        sd[f"{t}.k_idx"] = torch.arange(8).view(1, -1, 1, 1)
        sd[f"{t}.K_minus_1"] = torch.tensor([7.0]).view(1, -1, 1, 1)
    sd["core.core.pretrained.model.head.weight"] = torch.zeros(10, 32)
    path = tmp_path / "ZoeD_M12_NK.pt"
    torch.save({"model": sd}, path)
    _, dst = models("nk", beit=True)
    W.load_checkpoint(dst, str(path))
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
    assert "in_proj_weight" in "".join(src.state_dict())
    w = src.model.patch_transformer.transformer_encoder.layers[0] \
        .self_attn.in_proj_weight
    assert 0.1 < float(w.detach().std()) * np.sqrt(w.shape[1]) < 10
