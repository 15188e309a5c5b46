"""BEiT's streamed rel-pos bias tier on the port, against the JAX package.

Above DEPTHMAP_BIAS_STREAM_BYTES a BEiT block hands attention its resized
table and grid (``RelBiasSpec``) instead of a (1, H, N, N) bias.  On the
CPU the port runs ``attention_rel_streamed``, the JAX function restated
in plain torch; on the card K1's table mode computes the same index
(``ops/flash_attention.py rel_pos_index``, held here to timm's
``gen_relative_position_index`` for every pair).  Inputs are made with
numpy from a seed and fed to both packages; JAX runs on the CPU with
``use_flash=False``, as its own tests run it.  Bound: 2e-5 in f32, the
bound the JAX package holds its streamed tier to against the
materialized bias (tests/test_flash_attention.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import attention as jattn
from depthmap_tpu.models import beit as jbeit
from depthmap_tpu_torch.models import attention as tattn
from depthmap_tpu_torch.models import beit as tbeit
from depthmap_tpu_torch.ops import flash_attention as fa

TOL = 2e-5
# non-square grids first (a swapped gh / gw is right on square grids only)
GRIDS = [(5, 7), (3, 4), (7, 5), (4, 4), (1, 3), (2, 1)]


def _inputs(seed, grid, b=2, h=3, d=8):
    """q, k, v (b, h, N, d) and a (num_rel + 3, h) table with a spread of a
    few units, f32 numpy."""
    rng = np.random.default_rng(seed)
    gh, gw = grid
    n = gh * gw + 1
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for _ in range(3))
    table = (3.0 * rng.normal(size=(num_rel + 3, h))).astype(np.float32)
    return q, k, v, table


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("grid", GRIDS)
def test_kernel_index_equals_timm_index(grid):
    """The index K1's table mode computes (restated by rel_pos_index) is
    timm's for every (query, key) pair, against both packages'
    gen_relative_position_index."""
    gh, gw = grid
    t = torch.arange(gh * gw + 1)
    got = fa.rel_pos_index(t, t, grid)
    np.testing.assert_array_equal(got.numpy(),
                                  jbeit.gen_relative_position_index(gh, gw))
    assert torch.equal(got, tbeit.gen_relative_position_index(gh, gw))


@pytest.mark.parametrize("grid,chunk", [((5, 7), 16), ((3, 4), 5),
                                        ((7, 5), 512), ((4, 4), 7)])
def test_streamed_matches_jax(grid, chunk):
    """attention_rel_streamed against the JAX function, chunks that do not
    divide N (padded queries, clipped indices)."""
    q, k, v, table = _inputs(1, grid)
    spec = jattn.RelBiasSpec(jnp.asarray(table), *grid)
    want = np.asarray(jattn.attention_rel_streamed(
        *map(jnp.asarray, (q, k, v)), spec, chunk=chunk, use_flash=False))
    got = tattn.attention_rel_streamed(
        *_t(q, k, v), tattn.RelBiasSpec(torch.from_numpy(table), *grid),
        chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("grid", GRIDS[:4])
def test_streamed_matches_materialized(grid):
    """The plain streamed version against flash_attention_plain with the
    materialized rel_pos_bias; attention() sends a RelBiasSpec on CPU
    tensors there."""
    q, k, v, table = _inputs(2, grid)
    q, k, v, tab = _t(q, k, v, table)
    want = fa.flash_attention_plain(
        q, k, v, tbeit.rel_pos_bias(tab, grid, grid))
    spec = tattn.RelBiasSpec(tab, *grid)
    for got in (tattn.attention_rel_streamed(q, k, v, spec, chunk=8),
                tattn.attention(q, k, v, spec)):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_table_mode_refuses_what_it_does_not_take():
    """The table-mode wrapper checks N against the grid and the table's
    shape, and takes CUDA tensors only: its plain version is
    attention_rel_streamed, reached through attention()."""
    q = torch.zeros(1, 2, 13, 64)
    with pytest.raises(ValueError, match="N = Nk"):
        fa.flash_attention_rel(q, q, q, torch.zeros(2, 66), (3, 5))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_rel(q, q, q, torch.zeros(38, 2), (3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_rel(q, q, q, torch.zeros(38, 2).t(), (3, 4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention_rel(q, q, q, torch.zeros(2, 38), (3, 4))


def _jax_backbone():
    return jbeit.BeitBackbone(embed_dim=32, depth=2, num_heads=2,
                              hooks=(0, 1), train_img_size=64, patch_size=16)


def _torch_backbone(params):
    """The port's BeitBackbone with the JAX backbone's parameters (the
    backbone half of state_dict_from_jax, without ``pretrained.``)."""
    from depthmap_tpu_torch.models.weights import _beit_body
    bb = tbeit.BeitBackbone(embed_dim=32, depth=2, num_heads=2, hooks=(0, 1),
                            train_img_size=64, patch_size=16)
    sd = {k[len("pretrained."):]: v
          for k, v in _beit_body(params["params"]).items()}
    bb.load_state_dict(sd, strict=True)
    return bb.eval()


def _backbone_params(seed):
    """The small backbone's JAX variables, every leaf redrawn with numpy
    (rel-pos tables with a spread of a few units)."""
    shapes = _jax_backbone().init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "relative_position_bias_table":
            return 2.0 * rng.normal(size=leaf.shape)
        if name in ("scale", "gamma_1", "gamma_2"):
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        if name == "kernel":
            return rng.normal(size=leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        return 0.1 * rng.normal(size=leaf.shape)
    out = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


class _Count:
    """Wrap ``module.name`` to count its calls."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        orig = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)


def test_backbone_streamed_matches_jax(monkeypatch):
    """A tiny BEiT backbone on a 4 x 6 grid (the table resized from 4 x 4)
    with DEPTHMAP_BIAS_STREAM_BYTES=0 against the JAX BeitBackbone under
    the same env: both stream (each block once), and the features agree;
    the port's streamed features equal its inline ones."""
    params = _backbone_params(3)
    x = np.random.default_rng(4).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    bb = _torch_backbone(params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    monkeypatch.delenv("DEPTHMAP_BIAS_STREAM_BYTES", raising=False)
    with torch.no_grad():
        inline, _ = bb(xt)
    monkeypatch.setenv("DEPTHMAP_BIAS_STREAM_BYTES", "0")
    j_count = _Count(monkeypatch, jattn, "attention_rel_streamed")
    t_count = _Count(monkeypatch, tattn, "attention_rel_streamed")
    want, jgrid = _jax_backbone().apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, grid = bb(xt)
    assert (j_count.calls, t_count.calls) == (2, 2)
    assert tuple(grid) == tuple(jgrid) == (4, 6)
    for a, w, i in zip(got, want, inline):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
        torch.testing.assert_close(a, i, atol=TOL, rtol=TOL)


# (grid, heads) -> N, and budgets on both sides of each block's bias bytes
TIER_CASES = [((4, 6), 2), ((3, 3), 2), ((5, 7), 2)]


def _jax_tier(monkeypatch, params, x):
    count = _Count(monkeypatch, jattn, "attention_rel_streamed")
    _jax_backbone().apply(params, jnp.asarray(x))
    return count.calls > 0


@pytest.mark.parametrize("grid,heads", TIER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_choice_matches_jax(monkeypatch, grid, heads, dtype):
    """Whether a block streams, the port's (streams_bias, as its backbone
    runs it) against the JAX backbone's own choice under the same env, at
    budgets of the bias's bytes - 1, the bytes, and unset."""
    params = _backbone_params(5)
    gh, gw = grid
    x = np.zeros((1, 16 * gh, 16 * gw, 3), np.float32)
    n = gh * gw + 1
    item = 4 if dtype == "float32" else 2
    nbytes = heads * n * n * item
    tdt = getattr(torch, dtype)
    for env in (str(nbytes - 1), str(nbytes), None):
        if env is None:
            monkeypatch.delenv("DEPTHMAP_BIAS_STREAM_BYTES", raising=False)
        else:
            monkeypatch.setenv("DEPTHMAP_BIAS_STREAM_BYTES", env)
        want = _jax_tier(monkeypatch, params, x.astype(jnp.dtype(dtype)))
        assert tbeit.streams_bias(heads, n, tdt) == want, (env, want)
        assert want == (env == str(nbytes - 1))


class _HoistInfo:
    """What the JAX predictor's ``_bias_hoist_ok`` reads of itself."""

    def __init__(self, depth, heads, dtype):
        self.core_dtype = jnp.dtype(dtype)
        self._bb = type("BB", (), {"depth": depth, "num_heads": heads})

    def _beit_hoist_info(self):
        return self._bb, None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("env", [None, "0", str(1 << 40)])
def test_tier_choice_matches_jax_at_full_size(monkeypatch, dtype, env):
    """The tier (hoisted / inline / streamed) of BEiT-L 512 (24 blocks, 16
    heads) at the N of the main path, ZoeDepth's k, Boost and the large
    net sizes: the port's grid_inputs on a meta-device backbone and its
    streams_bias against the JAX predictor's ``_bias_hoist_ok`` and the
    JAX backbone's stream expression (depthmap_tpu/models/beit.py:144-148)
    under the same env."""
    from depthmap_tpu.pipeline.depth import DepthPredictor
    if env is None:
        monkeypatch.delenv("DEPTHMAP_BIAS_STREAM_BYTES", raising=False)
    else:
        monkeypatch.setenv("DEPTHMAP_BIAS_STREAM_BYTES", env)
    with torch.device("meta"):
        bb = tbeit.beit_large(512)
    jp = _HoistInfo(24, 16, dtype)
    tdt = getattr(torch, dtype)
    budget = int(env) if env is not None else 256 << 20
    item = jnp.dtype(dtype).itemsize
    tiers = []
    for grid in [(32, 32), (32, 56), (48, 48), (56, 56), (48, 64), (64, 64),
                 (72, 96), (100, 100), (128, 128)]:
        n = grid[0] * grid[1] + 1
        hoisted = DepthPredictor._bias_hoist_ok(jp, grid)
        jax_tier = "hoisted" if hoisted else \
            "streamed" if 16 * n * n * item > budget else "inline"
        port = bb.grid_inputs(grid, tdt)["rel_bias"] is not None
        port_tier = "hoisted" if port else \
            "streamed" if tbeit.streams_bias(16, n, tdt) else "inline"
        assert port_tier == jax_tier, (grid, dtype, env)
        tiers.append(port_tier)
    if env is None:   # each tier is reached
        assert set(tiers) == {"hoisted", "inline", "streamed"}


@pytest.mark.parametrize("grid", [(3, 4), (5, 7)])
@pytest.mark.parametrize("route", ["attention", "chunked_k1"])
def test_streamed_gradient_matches_jax(grid, route):
    """d(sum(out * dout)) / d(q, k, v, table) through the port's streamed
    tier against jax.grad of the JAX streamed function: ``attention`` on
    CPU tensors (the plain version under autograd) and the card's
    structure with grad (a gather per chunk into K1's layout, then
    FlashAttentionFunction, whose forward runs the plain version on the
    CPU), with chunks that do not divide N."""
    q, k, v, table = _inputs(6, grid)
    dout = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    chunk = 5

    def jloss(q, k, v, table):
        out = jattn.attention_rel_streamed(
            q, k, v, jattn.RelBiasSpec(table, *grid), chunk=chunk,
            use_flash=False)
        return (out * dout).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, table)))
    ins = [t.requires_grad_() for t in _t(q, k, v, table)]
    spec = tattn.RelBiasSpec(ins[3], *grid)
    if route == "attention":
        out = tattn.attention(*ins[:3], spec)
    else:
        out = tattn._attention_rel_grad(*ins[:3], spec, 8 ** -0.5,
                                        chunk=chunk)
    got = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), ins)
    for name, a, w in zip(("q", "k", "v", "table"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_smoke_holds_the_streamed_shapes():
    """chip_smoke.py's K1 shape guard (phases 13, 18 and 19) finds a
    phase-2 row for every K1 shape of BEiT-L 512's streamed paths: Boost at
    R_x 1536 on a 4:3 image (the whole image in table mode, the patches at
    1024^2 in chunks of 4, both with bias at 512) and net 1024, 1600 and
    2048 in each tier (a table-mode row holds the materialized bias at its
    shape); a shape no row holds is reported."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def key(b, gh, gw, mode):
        n = gh * gw + 1
        return smoke.k1_case_key("bfloat16", b, 16, n, n, mode)
    seen = {key(1, 72, 96, ("rel", 72, 96)), key(4, 64, 64, ("rel", 64, 64)),
            key(1, 24, 32, 1), key(4, 32, 32, 1)}
    for size in smoke.STREAM_NET_SIZES:
        g = size // 16
        assert tbeit.streams_bias(16, g * g + 1, torch.bfloat16)
        seen |= {key(1, g, g, ("rel", g, g)), key(1, g, g, 1)}
    assert smoke.k1_shapes_not_held(seen) == []
    odd = key(2, 64, 64, ("rel", 64, 64))
    assert smoke.k1_shapes_not_held(seen | {odd}) == [odd]
