"""The port's MiDaS zoo (types 2-6) against the JAX package's, on the same
weights.

Small configurations: the ViT-L stand-in and the hybrid have embed 128 and
2 heads of D = 64 with a training grid of 4 x 4, run at 80 x 112 inputs (a
5 x 7 grid, so the position embedding is resized); the hybrid's ResNetV2
has one block a stage, midas_v21's ResNeXt one block a layer (8 groups of
width 4) and midas_v21_small's EfficientNet-Lite3 at most two blocks a
stage.  The JAX package builds those encoders by name inside its modules,
so the small ones are put in their place for the tests that need them
(monkeypatch).  Weights are drawn with numpy from a seed in the JAX layout
and carried into the port with ``state_dict_from_jax``.  f32 throughout;
bound atol 3e-3, rtol 1e-3, the bound of tests/test_torch_port_model.py.
The full-width modules are built on the meta device: their keys are held
against each converter, their shapes against the JAX modules'.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import efficientnet as jeff
from depthmap_tpu.models import midas_net as jmidas_net
from depthmap_tpu.models import midas_small as jmidas_small
from depthmap_tpu.models import resnet as jresnet
from depthmap_tpu.models import vit as jvit
from depthmap_tpu_torch.models.build import build_model
from depthmap_tpu_torch.models.weights import (init_random_, load_checkpoint,
                                               state_dict_from_jax)

ATOL, RTOL = 3e-3, 1e-3
VIT = dict(embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
           train_grid=4)
HYBRID = dict(embed_dim=128, depth=4, num_heads=2, hooks=(1, 3),
              train_grid=4)
RN_LAYERS = (1, 1, 1)
RESNEXT = dict(layers=(1, 1, 1, 1), groups=8, width_per_group=4)
FEATURES = 32
# kind -> (input (H, W), reassemble channels of the DPT kinds)
KINDS = {"vit": ((80, 112), (16, 32, 64, 64)),
         "hybrid": ((80, 112), (256, 512, 64, 64)),
         "v21": ((64, 96), None), "small": ((64, 96), None)}


def _small_lite(cfgs):
    return tuple(dataclasses.replace(c, repeats=min(c.repeats, 2))
                 for c in cfgs)


@pytest.fixture
def small_encoders(monkeypatch):
    """The JAX modules build their encoders by name: small ones instead."""
    monkeypatch.setattr(jvit, "ResNetV2Stages", functools.partial(
        jvit.ResNetV2Stages, layers=RN_LAYERS))
    monkeypatch.setattr(jmidas_net, "ResNeXtBackbone", functools.partial(
        jresnet.ResNeXtBackbone, **RESNEXT))
    small = _small_lite(jeff.LITE3)
    monkeypatch.setattr(jmidas_small, "EfficientNetLiteBackbone",
                        functools.partial(jeff.EfficientNetLiteBackbone,
                                          cfgs=small))
    monkeypatch.setattr(jeff, "LITE3", small)   # convert_midas_small's


def jax_model(kind: str):
    from depthmap_tpu.models.dpt import DPTDepthModel
    if kind == "vit":
        return DPTDepthModel(backbone=jvit.VitBackbone(**VIT),
                             reassemble_channels=KINDS[kind][1],
                             features=FEATURES)
    if kind == "hybrid":
        return DPTDepthModel(backbone=jvit.HybridVitBackbone(**HYBRID),
                             reassemble_channels=KINDS[kind][1],
                             features=FEATURES, hybrid=True)
    if kind == "v21":
        return jmidas_net.MidasNet()
    return jmidas_small.MidasNetSmall()


def torch_model(kind: str, variables=None) -> torch.nn.Module:
    from depthmap_tpu_torch.models import efficientnet, midas_net, vit
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    if kind == "vit":
        m = DPTDepthModel(vit.VitBackbone(**VIT), KINDS[kind][1], FEATURES)
    elif kind == "hybrid":
        m = DPTDepthModel(vit.HybridVitBackbone(**HYBRID, layers=RN_LAYERS),
                          KINDS[kind][1], FEATURES)
    elif kind == "v21":
        m = midas_net.build_midas_v21(**RESNEXT)
    else:
        m = midas_net.build_midas_v21_small(
            cfgs=_small_lite(efficientnet.LITE3))
    if variables is not None:
        m.load_state_dict(state_dict_from_jax(variables), strict=True)
    return m.eval()


def _draw(shapes, seed):
    """Every leaf redrawn from a numpy generator: kernels ~ N(0, 1/fan_in),
    norm scales near 1, biases small and positive (the ReLU head stays
    live), BatchNorm means near 0 and variances in [0.5, 1.5], position
    embeddings large enough to matter."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "bias":
            return 0.05 + 0.05 * rng.random(size=shape)
        if name == "var":
            return 0.5 + rng.random(size=shape)
        if name == "pos_embed":
            return 0.5 * rng.normal(size=shape)
        return 0.1 * rng.normal(size=shape)

    out = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def jax_variables(kind: str, seed: int):
    (h, w), _ = KINDS[kind]
    shapes = jax.eval_shape(jax_model(kind).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3)))
    return _draw(shapes, seed)


def jax_apply(kind: str, variables, x: np.ndarray) -> np.ndarray:
    """The JAX model's forward, jitted (a fresh function each call, so the
    tiling flag read while tracing is the current one)."""
    model = jax_model(kind)
    return np.asarray(jax.jit(lambda v, a: model.apply(v, a))(
        variables, jnp.asarray(x)))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _input(kind: str, seed: int, batch: int = 2) -> np.ndarray:
    (h, w), _ = KINDS[kind]
    return np.random.default_rng(seed).normal(
        size=(batch, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_small_model_matches_jax(small_encoders, kind):
    variables = jax_variables(kind, seed=1)
    x = _input(kind, seed=2)
    want = jax_apply(kind, variables, x)
    with torch.no_grad():
        got = torch_model(kind, variables)(_nchw(x)).numpy()
    assert got.shape == want.shape == x.shape[:3]
    assert np.ptp(want) > 0.1         # a live, non-constant map
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_tiling_mode_matches_jax(small_encoders, kind):
    """Circular padding where the JAX flag reaches (padded convs and
    ConvSame), none in the hybrid's standardized convs or either max-pool."""
    from depthmap_tpu.models import layers as jlayers
    from depthmap_tpu_torch.models.layers import set_tiling_mode
    variables = jax_variables(kind, seed=3)
    x = _input(kind, seed=4, batch=1)
    jlayers.set_tiling_mode(True)
    try:
        want = jax_apply(kind, variables, x)
    finally:
        jlayers.set_tiling_mode(False)
    tm = torch_model(kind, variables)
    set_tiling_mode(tm, True)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
        set_tiling_mode(tm, False)
        plain = tm(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(plain - got).max() > 10 * ATOL   # the padding mattered


def _converter(kind: str, full: bool):
    from depthmap_tpu.models import convert as C
    if kind == "vit":
        return functools.partial(C.convert_dpt_vit,
                                 depth=24 if full else VIT["depth"])
    if kind == "hybrid":
        return functools.partial(C.convert_dpt_hybrid,
                                 depth=12 if full else HYBRID["depth"],
                                 layers=(3, 4, 9) if full else RN_LAYERS)
    if kind == "v21":
        return functools.partial(C.convert_midas_v21,
                                 layers=(3, 4, 23, 3) if full
                                 else RESNEXT["layers"])
    if kind == "beit":
        return functools.partial(C.convert_dpt_beit, depth=24)
    return C.convert_midas_small


@pytest.mark.parametrize("kind", list(KINDS))
def test_weights_round_trip(small_encoders, kind):
    """convert_*(state_dict_from_jax(v)) reproduces every leaf of v
    exactly; the only keys it leaves are midas_v21's refinenet4
    resConfUnit1, which the JAX tree lacks (filled with zeros)."""
    from depthmap_tpu.models.convert import SDict
    variables = jax_variables(kind, seed=5)
    sd = state_dict_from_jax(variables)
    s = SDict(sd)
    back = _converter(kind, full=False)(s)
    assert s.unused() == []
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))
    extra = {jax.tree_util.keystr(p) for p in flat_b} - {
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_leaves_with_path(variables)}
    assert all("refinenet4']['resConfUnit1" in k for k in extra)
    assert bool(extra) == (kind == "v21")


# full-width checkpoint layouts: model type -> the converter's kind
FULL = {2: "beit", 3: "vit", 4: "hybrid", 5: "v21", 6: "small"}


@pytest.mark.parametrize("mt", sorted(FULL))
def test_full_width_layout_matches_converter(mt):
    """The full-width module names exactly the keys its converter reads
    (midas_v21's dead refinenet4 resConfUnit1 included: the converter
    takes it where the checkpoint has it), and the converted tree has the
    JAX module's shapes."""
    from depthmap_tpu.models.build import build_model as j_build
    from depthmap_tpu.models.convert import SDict
    with torch.device("meta"):     # shapes only, no memory
        m = build_model(mt).module
    s = SDict({k: np.broadcast_to(np.float32(0), tuple(v.shape))
               for k, v in m.state_dict().items()})
    conv = _converter(FULL[mt], full=True)(s)
    assert s.unused() == []
    jshapes = jax.eval_shape(j_build(mt).module.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 64, 3)))
    got = {jax.tree_util.keystr(p): np.shape(v) for p, v in
           jax.tree_util.tree_leaves_with_path(conv)}
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_leaves_with_path(jshapes)}
    assert {k: got[k] for k in want} == want
    extra = set(got) - set(want)
    assert all("refinenet4']['resConfUnit1" in k for k in extra)
    assert bool(extra) == (mt == 5)


def test_strict_checkpoint_load(tmp_path):
    """A hybrid checkpoint in the reference layout, with the timm keys the
    DPT hooks never reach, loads with strict=True."""
    src = init_random_(torch_model("hybrid"), seed=3)
    sd = dict(src.state_dict())
    assert "pretrained.model.patch_embed.backbone.stages.2.blocks.0" \
        ".downsample.conv.weight" in sd
    sd["pretrained.model.norm.weight"] = torch.ones(HYBRID["embed_dim"])
    sd["pretrained.model.head.weight"] = torch.zeros(10, HYBRID["embed_dim"])
    path = tmp_path / "dpt_hybrid-midas-501f0c75.pt"
    torch.save(sd, path)
    dst = torch_model("hybrid")
    load_checkpoint(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_hybrid_grid_and_std_weight():
    """The hybrid's grid is the ResNet's stride-16 output (SAME stages
    round up), and its standardized conv weights are computed once per
    weight and again after the weight changes."""
    from depthmap_tpu_torch.models.vit import HybridVitBackbone
    bb = HybridVitBackbone(**HYBRID, layers=RN_LAYERS)
    assert bb.grid_for((80, 112)) == (5, 7)
    assert bb.grid_for((81, 100)) == (6, 7)
    conv = bb.model.patch_embed.backbone.stem.conv
    first = conv.standardized_weight()
    assert conv.standardized_weight() is first
    w = first.double().flatten(1)
    np.testing.assert_allclose(w.mean(1).numpy(), 0, atol=1e-6)
    np.testing.assert_allclose(w.var(1, unbiased=False).numpy(), 1,
                               atol=1e-3)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = conv.standardized_weight()
    assert again is not first
    torch.testing.assert_close(again, first, rtol=0, atol=1e-3)


def test_vit_pos_embed_resize_matches_jax():
    """resize_pos_embed alone at grids below, at and above the training
    one (1e-5: the JAX taps are f64-derived weights rounded to f32)."""
    from depthmap_tpu_torch.models.vit import resize_pos_embed
    pos = np.random.default_rng(6).normal(size=(1, 17, 128)).astype(
        np.float32)
    for gh, gw in ((3, 6), (4, 4), (5, 7), (9, 2)):
        want = np.asarray(jvit.resize_pos_embed(jnp.asarray(pos), gh, gw))
        got = resize_pos_embed(torch.from_numpy(pos), gh, gw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mt", [2, 3, 4, 5, 6])
def test_bundle_matches_jax(mt):
    """Preprocess config and upsample of each bundle as in the JAX
    package's build_model."""
    from depthmap_tpu.models.build import build_model as j_build
    with torch.device("meta"):
        tb = build_model(mt)
    jb = j_build(mt)
    assert (tb.upsample_mode, tb.upsample_align_corners) == \
        (jb.upsample_mode, jb.upsample_align_corners)
    for f in dataclasses.fields(tb.preprocess):
        assert getattr(tb.preprocess, f.name) == \
            getattr(jb.preprocess, f.name), f.name
