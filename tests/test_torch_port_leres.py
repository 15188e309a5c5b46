"""The port's LeReS (type 0) against the JAX package's, on the same
weights: the FTB quirk, RelDepthModel on a small ResNeXt (one block a
layer, 8 groups of width 4; the JAX module builds its encoder by name, so
the small one is put in its place), the bilinear ``squash`` preprocess
against the JAX package's cv2 resize, the weights' round trip and the
full-width layout; and the bundles of types 0 and 7-9.  f32; bound atol
3e-3, rtol 1e-3 (tests/test_torch_port_model.py's).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import leres as jleres
from depthmap_tpu.models import resnet as jresnet
from depthmap_tpu_torch.models import leres as tleres
from depthmap_tpu_torch.models.build import build_model
from depthmap_tpu_torch.models.weights import state_dict_from_jax
from tests.test_torch_port_midas import RESNEXT, _draw

ATOL, RTOL = 3e-3, 1e-3


@pytest.fixture
def small_resnext(monkeypatch):
    monkeypatch.setattr(jleres, "ResNeXtBackbone", functools.partial(
        jresnet.ResNeXtBackbone, **RESNEXT))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def jax_variables(module, seed: int, hw=(64, 96), cin=3):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, cin)))
    return _draw(shapes, seed)


def test_ftb_skip_carries_relu():
    """FTB's skip adds relu(conv1(x)) (the reference's in-place ReLU), as
    the JAX module does; the sum with conv1(x) itself would differ."""
    from depthmap_tpu_torch.models.weights import _put_bn, _put_conv
    jm = jleres.FTB(12)
    v = jax_variables(jm, seed=1, hw=(6, 10), cin=8)
    p, st = v["params"], v["batch_stats"]
    sd = {}
    _put_conv(sd, "conv1", p["conv1"]["conv"])
    _put_conv(sd, "conv_branch.1", p["branch_conv1"]["conv"])
    _put_bn(sd, "conv_branch.2", p["branch_bn"]["bn"], st["branch_bn"]["bn"])
    _put_conv(sd, "conv_branch.4", p["branch_conv2"]["conv"])
    tm = tleres.FTB(8, 12)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    x = np.random.default_rng(2).normal(size=(2, 6, 10, 8)).astype(
        np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x))
        pre = tm.conv1(_nchw(x))
        plain_skip = torch.relu(pre + tm.conv_branch(torch.relu(pre)))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (pre < 0).any()
    assert np.abs(plain_skip.permute(0, 2, 3, 1).numpy() - want).max() > \
        10 * ATOL


def test_small_model_matches_jax(small_resnext):
    jm = jleres.RelDepthModel()
    v = jax_variables(jm, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = tleres.build_leres(**RESNEXT)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(_nchw(x)).numpy()
    assert got.shape == want.shape == x.shape[:3]
    assert np.ptp(want) > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw", [(40, 50), (128, 192), (100, 150),
                                (70, 300)],
                         ids=["upscale", "exact_2x_down", "non_integer_down",
                              "mixed"])
def test_squash_bilinear_preprocess_matches_jax(hw):
    """LeReS's preprocess (squash to 96 x 64, cv2.INTER_LINEAR on f32,
    RGB, ImageNet mean and std) against the JAX package's cv2 resize; at
    an exact 2x downscale cv2 takes INTER_AREA, the same 2 x 2 mean.
    Bound 3e-5: cv2 rounds its f32 taps apart from torch, ~2e-6 of the
    [0, 1] range, which the 1/std scaling (up to 4.4x) lifts to ~1e-5."""
    from depthmap_tpu.models.build import build_model as j_build
    from depthmap_tpu.pipeline.preprocess import preprocess_image
    from depthmap_tpu_torch.pipeline.preprocess import preprocess_images
    cfg = j_build(0).preprocess
    with torch.device("meta"):
        tcfg = build_model(0).preprocess
    img = np.random.default_rng(5).random((*hw, 3)).astype(np.float32)
    want = preprocess_image(img, 96, 64, cfg)             # (1, 64, 96, 3)
    got = preprocess_images(torch.from_numpy(img)[None], 96, 64, tcfg)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 96, 3)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_weights_round_trip(small_resnext):
    """convert_leres(state_dict_from_jax(v)) reproduces every leaf of v
    exactly and reads every key."""
    from depthmap_tpu.models.convert import SDict, convert_leres
    v = jax_variables(jleres.RelDepthModel(), seed=6)
    sd = state_dict_from_jax(v)
    assert set(sd) == set(tleres.build_leres(**RESNEXT).state_dict())
    s = SDict(sd)
    back = convert_leres(s, layers=RESNEXT["layers"])
    assert s.unused() == []
    flat_b = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(back)}
    flat_v = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(v)}
    assert set(flat_b) == set(flat_v)
    for k, x in flat_v.items():
        np.testing.assert_array_equal(np.asarray(flat_b[k]), x, err_msg=k)


def test_full_width_layout_matches_converter():
    """res101 at full width names exactly the keys convert_leres reads,
    with the JAX module's shapes."""
    from depthmap_tpu.models.build import build_model as j_build
    from depthmap_tpu.models.convert import SDict, convert_leres
    with torch.device("meta"):
        m = build_model(0).module
    s = SDict({k: np.broadcast_to(np.float32(0), tuple(t.shape))
               for k, t in m.state_dict().items()})
    conv = convert_leres(s)
    assert s.unused() == []
    jshapes = jax.eval_shape(j_build(0).module.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 64, 3)))
    got = {jax.tree_util.keystr(p): np.shape(x) for p, x in
           jax.tree_util.tree_leaves_with_path(conv)}
    want = {jax.tree_util.keystr(p): x.shape for p, x in
            jax.tree_util.tree_leaves_with_path(jshapes)}
    assert got == want


def test_strict_checkpoint_load(tmp_path):
    """A res101.pth in the reference layout ('depth_model' dict, keys with
    'module.' and without the 'depth_model.' prefix) loads strictly."""
    from depthmap_tpu_torch.models.weights import init_random_, \
        load_checkpoint
    src = init_random_(tleres.build_leres(**RESNEXT), seed=7)
    sd = {"module." + k[len("depth_model."):]: t
          for k, t in src.state_dict().items()}
    path = tmp_path / "res101.pth"
    torch.save({"depth_model": sd}, path)
    dst = tleres.build_leres(**RESNEXT)
    load_checkpoint(dst, str(path))
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k


@pytest.mark.parametrize("mt", [0, 7, 8, 9])
def test_bundle_matches_jax(mt):
    """Preprocess config (resize rule, interpolation, channel order),
    upsample and output semantics as in the JAX package's build_model."""
    from depthmap_tpu.models.build import build_model as j_build
    with torch.device("meta"):
        tb = build_model(mt)
    jb = j_build(mt)
    for name in ("upsample_mode", "upsample_align_corners",
                 "predicts_depth", "prep_in_model"):
        assert getattr(tb, name) == getattr(jb, name), name
    for f in dataclasses.fields(jb.preprocess):
        assert getattr(tb.preprocess, f.name) == \
            getattr(jb.preprocess, f.name), f.name
