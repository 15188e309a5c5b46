"""The port's Depth Anything v1 / v2 (DINOv2 + DPT head) against the JAX
package's, on the same weights.

Small configurations (embed 128, 2 heads of D = 64, training size 56: a
4 x 4 grid) run at 70 x 98 inputs, a 5 x 7 grid, so the position
embeddings go through the +0.1 bicubic resize.  The JAX package builds its
encoder by name from ``DINOV2_CONFIGS``, so the small encoders are added
to that table for the duration of each test (monkeypatch).  Weights are
drawn with numpy from a seed in the JAX layout and carried into the port
with ``state_dict_from_jax``.  f32 throughout; bound atol 3e-3, rtol 1e-3,
the bound of tests/test_torch_port_model.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import dinov2 as jdinov2
from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.models.build import build_model
from depthmap_tpu_torch.models.weights import (init_random_, load_checkpoint,
                                               state_dict_from_jax)
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from tests.test_torch_port_funnel import I16_TOL, _FixedCache, _images, _run

ATOL, RTOL = 3e-3, 1e-3
TRAIN = 56
ENC = {  # small encoders: v2's every-third-block taps, v1's last four
    "t_backbone": dict(embed_dim=128, depth=4, num_heads=2,
                       hooks=(0, 1, 2, 3), train_img_size=TRAIN),
    "t_v2": dict(embed_dim=128, depth=8, num_heads=2, hooks=(1, 3, 5, 7),
                 train_img_size=TRAIN),
    "t_v1": dict(embed_dim=128, depth=8, num_heads=2, hooks=(4, 5, 6, 7),
                 train_img_size=TRAIN),
}
HEAD = dict(features=32, out_channels=(16, 32, 64, 64))
# full-width checkpoint layouts: model type -> encoder depth
FULL = {11: 24, 12: 12, 13: 12, 14: 24}


@pytest.fixture(autouse=True)
def small_encoders(monkeypatch):
    for name, cfg in ENC.items():
        monkeypatch.setitem(jdinov2.DINOV2_CONFIGS, name, cfg)


def _draw(shapes, seed):
    """Every leaf redrawn from a numpy generator: kernels ~ N(0, 1/fan_in),
    LayerNorm scales and layer scales near 1, biases small and positive
    (the ReLU head stays live), position embeddings large enough to
    matter."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "gamma_1", "gamma_2"):
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "bias":
            return 0.05 + 0.05 * rng.random(size=shape)
        if name == "pos_embed":
            return 0.5 * rng.normal(size=shape)
        return 0.1 * rng.normal(size=shape)

    out = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def jax_da(enc: str):
    from depthmap_tpu.models.depth_anything import DepthAnything
    return DepthAnything(encoder_variant=enc, **HEAD)


def jax_da_variables(enc: str, seed: int):
    shapes = jax.eval_shape(jax_da(enc).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, TRAIN, TRAIN, 3)))
    return _draw(shapes, seed)


def torch_da(enc: str, variables=None) -> torch.nn.Module:
    from depthmap_tpu_torch.models.depth_anything import DepthAnything
    from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone
    m = DepthAnything(DinoV2Backbone(**ENC[enc]), **HEAD)
    if variables is not None:
        m.load_state_dict(state_dict_from_jax(variables), strict=True)
    return m.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_dinov2_small_matches_jax():
    """Every tapped, normed token sequence at a 5 x 7 grid (training grid
    4 x 4: the position embeddings are resized)."""
    from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone
    jmod = jdinov2.build_dinov2("t_backbone")
    x = np.random.default_rng(1).normal(size=(2, 70, 98, 3)).astype(
        np.float32)
    variables = _draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 56, 56, 3))), seed=2)
    (jfeats, jgrid) = jmod.apply(variables, jnp.asarray(x))
    # carry the encoder across through the whole-model function
    sd = state_dict_from_jax({"params": {
        "pretrained": variables["params"],
        "depth_head": jax_da_variables("t_v2", 0)["params"]["depth_head"]}})
    tm = DinoV2Backbone(**ENC["t_backbone"]).eval()
    tm.load_state_dict({k[len("pretrained."):]: v for k, v in sd.items()
                        if k.startswith("pretrained.")}, strict=True)
    with torch.no_grad():
        feats, grid = tm(_nchw(x))
    assert grid == tuple(jgrid) == (5, 7)
    assert len(feats) == len(jfeats) == 4
    for got, (patch, cls) in zip(feats, jfeats):
        assert got.shape == (2, 36, 128)
        np.testing.assert_allclose(got[:, 1:].numpy(), np.asarray(patch),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(cls),
                                   atol=ATOL, rtol=RTOL)


def test_pos_embed_resize_matches_jax():
    """The +0.1 bicubic resize alone, at grids below, at and above the
    training one (1e-5: the JAX taps are f64-derived weights rounded to
    f32, torch's are f32)."""
    from depthmap_tpu.ops.resize import interpolate as jinterp
    from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone
    tm = DinoV2Backbone(**ENC["t_backbone"])
    pos = np.random.default_rng(3).normal(size=(1, 17, 128)).astype(
        np.float32)
    tm.pos_embed.data = torch.from_numpy(pos)
    for gh, gw in ((3, 6), (4, 4), (5, 7), (9, 2)):
        got = tm.pos_embed_for((gh, gw)).detach().numpy()
        grid = pos[0, 1:].reshape(4, 4, 128)
        if (gh, gw) != (4, 4):
            grid = np.asarray(jinterp(jnp.asarray(grid), (gh, gw), "bicubic",
                                      False, scales=((gh + 0.1) / 4,
                                                     (gw + 0.1) / 4)))
        want = np.concatenate([pos[:, :1], grid.reshape(1, gh * gw, 128)], 1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("enc", ["t_v2", "t_v1"])
def test_depth_anything_small_matches_jax(enc):
    variables = jax_da_variables(enc, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 70, 98, 3)).astype(
        np.float32)
    want = np.asarray(jax_da(enc).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_da(enc, variables)(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 70, 98)
    assert np.ptp(want) > 0.1         # a live, non-constant map
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mt", sorted(FULL))
def test_full_width_layout_matches_converter(mt):
    """The full-width module names exactly the keys convert_depth_anything
    reads (mask_token and refinenet4.resConfUnit1 included: the converter
    marks both), and the converted tree has the JAX module's shapes."""
    from depthmap_tpu.models.build import build_model as j_build
    from depthmap_tpu.models.convert import SDict, convert_depth_anything
    with torch.device("meta"):     # shapes only, no memory
        m = build_model(mt).module
    keys = m.state_dict()
    assert "pretrained.mask_token" in keys
    assert "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight" in keys
    s = SDict({k: np.broadcast_to(np.float32(0), tuple(v.shape))
               for k, v in keys.items()})
    conv = convert_depth_anything(s, depth=FULL[mt])
    assert s.unused() == []
    jshapes = jax.eval_shape(j_build(mt).module.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 28, 28, 3)))
    got = {jax.tree_util.keystr(p): np.shape(v) for p, v in
           jax.tree_util.tree_leaves_with_path(conv)}
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_leaves_with_path(jshapes)}
    assert {k: got[k] for k in want} == want
    assert all("refinenet4']['resConfUnit1" in k for k in set(got) - set(want))


def test_weights_round_trip():
    """convert_depth_anything(state_dict_from_jax(v)) reproduces every leaf
    of v exactly and uses every key."""
    from depthmap_tpu.models.convert import SDict, convert_depth_anything
    variables = jax_da_variables("t_v2", seed=6)
    sd = SDict(state_dict_from_jax(variables))
    back = convert_depth_anything(sd, depth=ENC["t_v2"]["depth"])
    assert sd.unused() == []
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))


def test_strict_checkpoint_load(tmp_path):
    """A checkpoint in the reference layout (mask_token and the dead
    refinenet4 unit included) loads with strict=True."""
    src = init_random_(torch_da("t_v2"), seed=3)
    sd = dict(src.state_dict())
    assert float(sd["pretrained.pos_embed"].std()) > 0.01
    path = tmp_path / "depth_anything_v2_vitb.pth"
    torch.save(sd, path)
    dst = torch_da("t_v2")
    load_checkpoint(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def _predictors(mt: int, enc: str, seed: int):
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor as TPred
    variables = jax_da_variables(enc, seed)
    jp = JPred(mt, params=variables, compute_dtype="float32")
    jp.bundle = dataclasses.replace(jp.bundle, module=jax_da(enc))
    with torch.device("meta"):
        bundle = build_model(mt)
    bundle = dataclasses.replace(bundle, module=torch_da(enc))
    tp = TPred(mt, state_dict=state_dict_from_jax(variables),
               compute_dtype=torch.float32, device="cpu", bundle=bundle)
    return jp, tp


@pytest.mark.parametrize("mt,enc", [(11, "t_v1"), (13, "t_v2")])
def test_predictor_matches_jax(rng, mt, enc):
    """predict_batch at net 70: lower_bound to multiples of 14, then the
    upsample back (type 11 bilinear with align_corners=False, 12-14
    align_corners=True), f32, to 1e-3 of the range."""
    from depthmap_tpu.models.build import build_model as j_build
    jp, tp = _predictors(mt, enc, seed=7)
    jb = j_build(mt)
    assert (tp.bundle.upsample_mode, tp.bundle.upsample_align_corners) == \
        (jb.upsample_mode, jb.upsample_align_corners) == \
        ("bilinear", mt != 11)
    for f in dataclasses.fields(tp.bundle.preprocess):
        assert getattr(tp.bundle.preprocess, f.name) == \
            getattr(jb.preprocess, f.name), f.name
    stack = np.stack(_images(rng, [(45, 77), (45, 77)])).astype(
        np.float32) / 255.0
    want = np.asarray(jp.predict_batch(stack, 70, 70))
    got = tp.predict_batch(stack, 70, 70)
    assert got.shape == want.shape == (2, 45, 77)
    rng_ = np.ptp(want)
    assert rng_ > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * rng_)


def test_default_options_funnel_matches_jax(rng):
    """GenerationOptions() defaults (Depth Anything v2 Base, net 448) on the
    CPU with the small model injected: two same-shape images ride the
    batched pre-pass (a 32 x 32 grid), the third the serial path
    (32 x 43)."""
    jp, tp = _predictors(13, "t_v2", seed=8)
    assert TOptions().model_type == JOptions().model_type == \
        "Depth Anything v2 Base"

    class JCache(jcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return jp

    imgs = _images(rng, [(64, 64), (64, 64), (48, 64)])
    want = _run(jcore.core_generation_funnel, imgs, None,
                JOptions(compute_device="CPU"), JCache())
    got = _run(tcore.core_generation_funnel, imgs, None,
               TOptions(compute_device="CPU"), _FixedCache(tp))
    assert set(got) == set(want) == {"depth"}
    assert [i for i, _ in got["depth"]] == [0, 1, 2]
    for (_, g), (_, w) in zip(got["depth"], want["depth"]):
        assert g.dtype == np.uint16 and g.shape == w.shape
        assert g.max() - g.min() > 1000       # a live map
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert d.max() <= I16_TOL, d.max()


def test_pos_embed_computed_once_per_grid(rng):
    """The predictor resizes the position embeddings once per net input
    size (70 x 126, a 5 x 9 grid) and reuses them; the forward with them
    equals the forward without."""
    _, tp = _predictors(13, "t_v2", seed=9)
    x = np.stack(_images(rng, [(45, 77)])).astype(np.float32) / 255.0
    first = tp.predict_batch(x, 70, 70)
    cached = dict(tp._grid_inputs)
    hw = (70, 126)
    key = (torch.device("cpu"), hw)
    assert list(cached) == [key] and list(cached[key]) == ["pos_embed"]
    assert cached[key]["pos_embed"].shape[1] == 5 * 9 + 1
    again = tp.predict_batch(x, 70, 70)
    assert tp.grid_inputs(hw)["pos_embed"] is cached[key]["pos_embed"]
    np.testing.assert_array_equal(first, again)
    from depthmap_tpu_torch.pipeline.preprocess import preprocess_images
    xin = preprocess_images(torch.from_numpy(x), 70, 70, tp.bundle.preprocess)
    with torch.no_grad():
        inline = tp.bundle.module(xin)
        hoisted = tp.bundle.module(xin, **cached[key])
    torch.testing.assert_close(hoisted, inline, rtol=0, atol=0)


def test_default_options_need_cuda(rng):
    """GenerationOptions() asks for the card: without CUDA the default
    request raises before any model is built; nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA error path")
    with pytest.raises(RuntimeError, match="CUDA"):
        list(tcore.core_generation_funnel(None, _images(rng, [(16, 16)]),
                                          None, None, TOptions()))


def test_tiling_mode_matches_jax():
    """Circular padding in every padded conv of the head (the stride-2
    resize conv included), as the JAX package's module-global flag does."""
    from depthmap_tpu.models import layers as jlayers
    from depthmap_tpu_torch.models.layers import set_tiling_mode
    variables = jax_da_variables("t_v2", seed=10)
    x = np.random.default_rng(11).normal(size=(1, 56, 84, 3)).astype(
        np.float32)
    jlayers.set_tiling_mode(True)
    try:
        want = np.asarray(jax_da("t_v2").apply(variables, jnp.asarray(x)))
    finally:
        jlayers.set_tiling_mode(False)
    tm = torch_da("t_v2", variables)
    set_tiling_mode(tm, True)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
        set_tiling_mode(tm, False)
        plain = tm(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(plain - got).max() > 10 * ATOL   # the padding mattered
