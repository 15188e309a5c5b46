"""The port's ``parallel/`` and its splits against the JAX package's, on
the CPU.

- The placement policy (``tree_placements``) against JAX's
  ``tree_pspecs``, key by key: every torch key gets a distinct constant,
  the JAX converter carries the constants into the JAX tree (transposing
  the Linear weights), and each JAX leaf's PartitionSpec must be its torch
  key's placement transposed (("model", None) <-> ``P(None, "model")``,
  (None, "model") <-> ``P("model", None)``).  On the multichip dryrun's tiny
  DPT and on meta-device full-width BEiT-L 512, ViT-L 384 and DINOv2-L
  (Depth Anything v2 Large) trees: the constants are broadcast views, so
  nothing full-width is allocated.
- The sharded train step in spawned gloo processes (file store, timeouts)
  at data = 2 and at model = 2 (the tiny ViT DPT, and a BEiT one for its
  sliced bias, inline and streamed), against the world-1 step on the whole batch: the loss (rtol 1e-5), the gradients and the updated parameters
  at the bounds of tests/test_torch_port_train.py (the step's gradient
  moves with the forward's last bits where the ReLU head leaves pred near
  0, and Adam's first step flips with a gradient's sign near 0).
- The four inference splits over CPU device lists against the JAX
  package's runs on tests/conftest.py's 8 virtual devices, so over 8
  devices (JAX's Boost chunk is merge_batch x 8, the port's the same):
  predict_batch and Boost at their port tests' bounds, Marigold's members
  at 1e-4 (tests/test_torch_port_marigold_pipeline.py's), the polylines
  rows byte-exact; and each split against its own unsplit run.
- A module's copies on other devices follow its weights.
- ``graft_entry.dryrun_multichip(4)``: (data, model) = (2, 2).
"""
from __future__ import annotations

import functools

import cv2
import numpy as np
import pytest
import torch

import jax

from depthmap_tpu_torch import graft_entry
from depthmap_tpu_torch.parallel import mesh
from depthmap_tpu_torch.parallel.mesh import (param_placement, replica,
                                              split_run, tree_placements)
from tests.test_torch_port_boost import (assert_boost_close, engines, scene,
                                         small_boost)  # noqa: F401
from tests.test_torch_port_marigold import (jax_noise,  # noqa: F401
                                            tiny_marigold)
from tests.test_torch_port_midas import small_encoders  # noqa: F401
from tests.test_torch_port_train import STEP_GRAD_RTOL, assert_grads_close

CPU8 = [torch.device("cpu")] * 8


# -- the placement policy --------------------------------------------------

def _jax_spec(placement):
    """A torch weight's placement on flax's transposed kernel."""
    from jax.sharding import PartitionSpec as P
    return P(*placement[::-1])


def assert_policy_matches(keys, convert):
    """``keys``: torch name -> shape; ``convert``: an SDict -> JAX tree."""
    from depthmap_tpu.models.convert import SDict
    from depthmap_tpu.parallel.mesh import tree_pspecs
    names = sorted(keys)
    sd = SDict({k: np.broadcast_to(np.float32(i), keys[k])
                for i, k in enumerate(names)})
    tree = convert(sd)
    pspecs = tree_pspecs(tree)
    want = tree_placements({k: torch.empty(keys[k], device="meta")
                            for k in names})
    seen, split = set(), 0
    for (path, leaf), (_, spec) in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves_with_path(
                pspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        key = names[int(np.asarray(leaf)[(0,) * np.ndim(leaf)])]
        assert spec == _jax_spec(want[key]), (jax.tree_util.keystr(path),
                                              key, spec, want[key])
        seen.add(key)
        split += spec != jax.sharding.PartitionSpec()
    # keys the JAX tree has no leaf for are buffers, all replicated
    for key in set(names) - seen:
        assert _jax_spec(want[key]) == jax.sharding.PartitionSpec(), key
    return split


def test_placement_policy_on_the_tiny_dpt():
    from depthmap_tpu.models.convert import convert_dpt_vit
    model = graft_entry.tiny_dpt()
    keys = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    split = assert_policy_matches(keys, functools.partial(convert_dpt_vit,
                                                          depth=4))
    assert split == 4 * 4       # qkv, proj, fc1, fc2 in 4 blocks
    # the policy keys on the layer's name and a 2-D weight only
    assert param_placement("blocks.0.attn.qkv.weight",
                           torch.empty(6, 2)) == ("model", None)
    assert param_placement("blocks.0.attn.proj.weight",
                           torch.empty(2, 2)) == (None, "model")
    assert param_placement("blocks.0.attn.qkv.bias", torch.empty(6)) == ()
    assert param_placement("patch_embed.proj.weight",
                           torch.empty(4, 3, 2, 2)) == ()


@pytest.mark.parametrize("mt,depth", [(1, 24), (3, 24), (14, 24)])
def test_placement_policy_full_width(mt, depth):
    """BEiT-L 512 (type 1), ViT-L 384 (3) and DINOv2-L (Depth Anything v2
    Large, 14) on the meta device."""
    from depthmap_tpu.models import convert as C
    from depthmap_tpu_torch.models.build import build_model
    with torch.device("meta"):
        module = build_model(mt).module
    keys = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    convert = {1: C.convert_dpt_beit, 3: C.convert_dpt_vit,
               14: C.convert_depth_anything}[mt]
    assert assert_policy_matches(keys, functools.partial(
        convert, depth=depth)) == 4 * depth


# -- the sharded train step in gloo processes ------------------------------

@functools.lru_cache(maxsize=None)
def world_1_step(backbone: str):
    from depthmap_tpu_torch.parallel.train import make_train_step
    model = graft_entry.tiny_dpt(backbone=backbone)
    step = make_train_step(model, functools.partial(
        torch.optim.Adam, lr=graft_entry.LEARNING_RATE))
    loss = float(step(*graft_entry.dryrun_batch(2)))
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    params = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return loss, grads, params


@pytest.mark.parametrize("data,model,backbone", [
    (2, 1, "vit"), (1, 2, "vit"), (1, 2, "beit")])
def test_gloo_step_matches_world_1(data, model, backbone):
    """At model = 2 each rank holds one of the 2 heads; the BEiT case
    slices the rel-pos bias to it and sums the tables' gradients."""
    assert_gloo_step_matches(data, model, backbone, world_1_step(backbone))


def assert_gloo_step_matches(data, model, backbone, want):
    """The sharded step in data x model gloo processes against ``want``,
    the world-1 step's (loss, gradients, updated parameters)."""
    loss, shape, grads, params = graft_entry.spawn_gloo(
        data * model, graft_entry.train_worker,
        (model, 2, True, backbone), 120.0)
    assert shape == {"data": data, "model": model}
    want_loss, want_g, want_p = want
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(grads) == set(want_g) and set(params) == set(want_p)
    assert_grads_close(grads, want_g, want_g, STEP_GRAD_RTOL)
    lr = graft_entry.LEARNING_RATE
    for k, want in want_p.items():
        err = np.abs(params[k] - want)
        assert params[k].shape == want.shape, k
        assert err.max(initial=0) <= 2 * lr + 1e-6, (k, err.max())
        if k in want_g:
            firm = np.abs(want_g[k]) > STEP_GRAD_RTOL * np.abs(
                want_g[k]).max()
            assert err[firm].max(initial=0) <= 1e-6, k


def test_gloo_beit_streamed_step_matches_world_1(monkeypatch):
    """The BEiT case at model = 2 in the streamed tier (a stream budget of
    0): each rank's attention gets its heads' columns of the resized table,
    and the step's loss, gradients (the tables' included) and parameters
    match the world-1 streamed step's."""
    from depthmap_tpu_torch.models import attention as tattn
    monkeypatch.setenv("DEPTHMAP_BIAS_STREAM_BYTES", "0")
    calls = []
    real = tattn.attention_rel_streamed
    monkeypatch.setattr(tattn, "attention_rel_streamed",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = world_1_step.__wrapped__("beit")
    assert calls, "the world-1 step did not stream"
    assert any("relative_position_bias_table" in k for k in want[1])
    assert_gloo_step_matches(1, 2, "beit", want)


def test_split_run_shards_in_order():
    """Equal shards in order where the device count divides the batch,
    one call where it does not, the rows padded with ``pad``."""
    seen = []

    def fn(x, y):
        seen.append(x.shape[0])
        return x * 2 + y

    x = torch.arange(12.0).reshape(6, 2)
    y = torch.ones(6, 1)
    out = split_run(fn, [torch.device("cpu")] * 3, x, y)
    torch.testing.assert_close(out, x * 2 + 1, rtol=0, atol=0)
    assert seen == [2, 2, 2]
    for devices, count in ((CPU8, 5), ([torch.device("cpu")], 6),
                           (CPU8, 3)):
        seen.clear()
        out = split_run(fn, devices, x[:count], y[:count])
        assert seen == [count] and out.shape == (count, 2)
    seen.clear()
    out = split_run(fn, CPU8[:4], x[:5], y[:5], pad=True)
    torch.testing.assert_close(out, x[:5] * 2 + 1, rtol=0, atol=0)
    assert seen == [2, 2, 2, 2]


def test_replica_follows_the_weights():
    """A copy on another device is kept while the weights stand and made
    anew after an in-place write or a load; a train step marks its
    parameters written even where a fused optimizer leaves no trace."""
    from depthmap_tpu_torch.parallel.train import make_train_step
    model = graft_entry.tiny_dpt()
    first = replica(model, "meta")
    assert first is not model and replica(model, "meta") is first
    assert replica(model, "cpu") is model
    with torch.no_grad():
        next(model.parameters()).add_(1.0)
    second = replica(model, "meta")
    assert second is not first and replica(model, "meta") is second
    model.load_state_dict(graft_entry.tiny_dpt(seed=1).state_dict())
    third = replica(model, "meta")
    assert third is not second
    step = make_train_step(model, functools.partial(
        torch.optim.Adam, lr=1e-4, fused=True))
    step(*graft_entry.dryrun_batch(2))
    assert replica(model, "meta") is not third


# -- the inference splits against JAX on 8 virtual devices ------------------

def test_predict_batch_split_matches_jax(small_encoders):
    from tests.test_torch_port_zoo_funnel import _predictors
    assert len(jax.devices()) == 8
    jp, tp = _predictors(6, seed=61)
    tp.devices = CPU8
    rng = np.random.default_rng(61)
    frames = rng.random((8, 48, 64, 3)).astype(np.float32)
    want = np.asarray(jp.predict_batch(frames, 64, 64))
    got = tp.predict_batch(frames, 64, 64)
    span = np.ptp(want)
    assert span > 0 and got.shape == want.shape == (8, 48, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * span)
    tp.devices = [torch.device("cpu")]
    np.testing.assert_allclose(got, tp.predict_batch(frames, 64, 64),
                               rtol=0, atol=1e-5)


def test_boost_split_matches_jax(small_boost, small_encoders):
    from tests.test_torch_port_zoo_funnel import _predictors
    jp, tp = _predictors(2, seed=62)
    je, te = engines(jp, tp)
    tp.devices = CPU8
    img = scene(13, 96, 128)
    want = je.estimate(img, whole_size_threshold=256)
    got = te.estimate(img, whole_size_threshold=256)
    assert te.last_run["chunks"] == -(-te.last_run["patches"] // 32)
    assert_boost_close(got, want)
    tp.devices = [torch.device("cpu")]
    np.testing.assert_allclose(got, te.estimate(
        img, whole_size_threshold=256), rtol=0, atol=1e-5)


def test_marigold_member_split_matches_jax(tiny_marigold, monkeypatch):
    """4 members over the 8 devices: 4 shards of one; the noise drawn
    once before the split."""
    from depthmap_tpu_torch.models.marigold import pipeline as tmp
    from tests.test_torch_port_marigold import torch_pipeline
    monkeypatch.setenv("DEPTHMAP_SHARD_ENSEMBLE", "1")
    jpipe = tiny_marigold
    tpipe = torch_pipeline(jpipe.vars)
    img = scene(14, 40, 56)
    rgb = cv2.resize(img, (64, 48), interpolation=cv2.INTER_CUBIC).clip(0, 1)
    batch = np.repeat(rgb[None], 4, axis=0)
    rngs = jax.random.split(jax.random.PRNGKey(3), 4)
    jbatch, jrngs, real = jpipe._shard_ensemble(batch, rngs)
    assert len(jbatch.sharding.device_set) == 4
    want = jpipe.single_infer(jbatch, 2, jrngs)[:real]
    assert tmp.MarigoldPipeline.ensemble_devices(4, CPU8) == CPU8[:4]
    run = functools.partial(tpipe.members, img, processing_res=64,
                            ensemble_size=4, denoising_steps=2,
                            noise=jax_noise(4, 6, 8, 3))
    got = run(devices=CPU8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, run(), rtol=0, atol=1e-5)
    monkeypatch.delenv("DEPTHMAP_SHARD_ENSEMBLE")
    assert tmp.MarigoldPipeline.ensemble_devices(4, CPU8) == []
    assert tmp.MarigoldPipeline.ensemble_devices(
        5, [torch.device("meta")] * 4) == []


def test_polylines_row_split_matches_jax(monkeypatch):
    """35 rows (4 x 8 + 3) over 8 devices, padded to 40, byte-exact
    against JAX's shard_map over 8 devices and against one launch; the
    switch's three settings."""
    from depthmap_tpu.ops.polylines_pallas import polylines_rasterize_pallas
    from depthmap_tpu_torch.ops import polylines as P
    rng = np.random.default_rng(8)
    h, w = 4 * 8 + 3, 96
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    nd = rng.random((h, w)).astype(np.float32)
    want = np.asarray(polylines_rasterize_pallas(img, nd, 2.3, 0.5, 1.0,
                                                 True, interpret=True,
                                                 shard=True))
    fill = functools.partial(P.polylines_rasterize, torch.from_numpy(img),
                             torch.from_numpy(nd), 2.3, 0.5, 1.0, True)
    cpu = torch.device("cpu")
    assert P.row_devices(cpu) is None
    assert P.row_devices(cpu, shard=True) == [cpu]
    np.testing.assert_array_equal(fill(shard=True).numpy(), want)
    monkeypatch.setenv("DEPTHMAP_POLYLINES_SHARD", "1")
    assert P.row_devices(cpu) == [cpu]
    # JAX's 8 virtual devices: a device list that repeats the CPU
    monkeypatch.setattr(mesh, "local_devices", lambda device="cuda": CPU8)
    monkeypatch.delenv("DEPTHMAP_POLYLINES_SHARD")
    assert P.row_devices(cpu) == CPU8
    launches = P.polylines_host.launches
    got = fill().numpy()
    assert P.polylines_host.launches == launches + 8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fill(shard=False).numpy(), want)
    monkeypatch.setenv("DEPTHMAP_POLYLINES_SHARD", "0")
    assert P.row_devices(cpu) is None
    assert P.row_devices(cpu, shard=True) == CPU8


def test_dryrun_multichip_entrypoint(capsys):
    graft_entry.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): mesh={'data': 2, 'model': 2}" in out
    assert out.count(" OK") == 4 and "byte-exact" in out
