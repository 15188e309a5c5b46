"""The port's DPT-BEiT against the JAX package's, on the same weights.

A small DPT-BEiT (depth 4, embed 64, 4 heads, train size 64) runs at a
64x96 input, so the 4x6 token grid differs from the 4x4 training window
and the width-major table resize is exercised.  Weights are made with numpy
from a seed, initialised in the JAX layout and carried into the port with
``state_dict_from_jax``.  Bound: atol 3e-3, rtol 1e-3 in f32, the bound of
tests/test_torch_oracle_parity.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu_torch.models.build import build_model
from depthmap_tpu_torch.models.weights import (init_random_, load_checkpoint,
                                               state_dict_from_jax)

SMALL = dict(depth=4, embed_dim=64, num_heads=4, train_img_size=64,
             hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
             features=32)
ATOL, RTOL = 3e-3, 1e-3


def jax_small_module():
    from depthmap_tpu.models.beit import BeitBackbone
    from depthmap_tpu.models.dpt import DPTDepthModel
    return DPTDepthModel(
        backbone=BeitBackbone(embed_dim=SMALL["embed_dim"],
                              depth=SMALL["depth"],
                              num_heads=SMALL["num_heads"],
                              hooks=SMALL["hooks"],
                              train_img_size=SMALL["train_img_size"]),
        reassemble_channels=SMALL["reassemble_channels"],
        features=SMALL["features"])


def jax_small_variables(seed: int):
    """Flax variables with every leaf redrawn from a numpy generator:
    kernels ~ N(0, 1/fan_in), LayerNorm scales and gammas near 1, biases
    small and positive (so the ReLU head does not die), rel-pos tables
    large enough to shape the attention."""
    shapes = jax_small_module().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape) / np.sqrt(fan_in)
        if name in ("scale", "gamma_1", "gamma_2"):
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "relative_position_bias_table":
            return 0.5 * rng.normal(size=shape)
        if name == "bias":
            return 0.05 + 0.05 * rng.random(size=shape)
        return 0.1 * rng.normal(size=shape)

    out = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def torch_small_module(variables=None) -> torch.nn.Module:
    """The port's small DPT-BEiT, with the JAX variables when given."""
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    m = DPTDepthModel(
        BeitBackbone(embed_dim=SMALL["embed_dim"], depth=SMALL["depth"],
                     num_heads=SMALL["num_heads"], hooks=SMALL["hooks"],
                     train_img_size=SMALL["train_img_size"]),
        reassemble_channels=SMALL["reassemble_channels"],
        features=SMALL["features"])
    if variables is not None:
        m.load_state_dict(state_dict_from_jax(variables), strict=True)
    return m.eval()


def torch_small_bundle():
    """build_model(1)'s bundle around the small module (the full module is
    built on the meta device: shapes only)."""
    with torch.device("meta"):
        bundle = build_model(1)
    return dataclasses.replace(bundle, module=torch_small_module())


def test_dpt_beit_small_matches_jax():
    variables = jax_small_variables(seed=5)
    x = np.random.default_rng(6).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = np.asarray(jax_small_module().apply(variables, jnp.asarray(x)))
    tm = torch_small_module(variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 64, 96)
    assert np.ptp(want) > 0.1       # a live, non-constant map
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_hoisted_bias_equals_inline():
    """precompute_rel_biases (the per-grid hoist) gives the same forward
    as the per-block inline bias."""
    from depthmap_tpu_torch.models.beit import precompute_rel_biases
    tm = torch_small_module(jax_small_variables(seed=7))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        inline = tm(x)
        hoisted = tm(x, rel_bias=precompute_rel_biases(tm.pretrained,
                                                       (4, 6)))
    torch.testing.assert_close(hoisted, inline, rtol=0, atol=0)


def test_rel_pos_bias_table_resize_matches_jax():
    """The width-major bilinear table resize on a non-square window (1e-5:
    the JAX taps are f64-derived weights rounded to f32, torch's are f32).
    The bias is a view in K1's padded-row layout: rows a multiple of 16
    elements, heads packed behind them."""
    from depthmap_tpu.models.beit import RelPosBias
    from depthmap_tpu_torch.models.beit import rel_pos_bias
    from depthmap_tpu_torch.ops.flash_attention import bias_row_stride
    tw, heads = 6, 3
    table = np.random.default_rng(9).normal(
        size=((2 * tw - 1) ** 2 + 3, heads)).astype(np.float32)
    for window in ((4, 7), (6, 6), (9, 5)):
        want = np.asarray(RelPosBias(heads, (tw, tw)).apply(
            {"params": {"relative_position_bias_table": table}}, window))
        got = rel_pos_bias(torch.from_numpy(table), (tw, tw), window)
        n = window[0] * window[1] + 1
        assert got.shape == (1, heads, n, n)
        assert got.stride(-1) == 1 and got.stride(2) % 16 == 0
        assert got.stride(2) == -(-n // 16) * 16
        assert bias_row_stride(got) == got.stride(2)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [(4, 6), (6, 6), (5, 9)])
def test_precompute_rel_biases_bf16_keeps_padded_layout(window):
    """The hoist in bf16 casts the table before the gather, so every bias
    keeps the padded-row view, and its values equal the f32 bias cast to
    bf16 (a gather is exact)."""
    from depthmap_tpu_torch.models.beit import precompute_rel_biases
    from depthmap_tpu_torch.ops.flash_attention import bias_row_stride
    tm = torch_small_module(jax_small_variables(seed=11))
    n = window[0] * window[1] + 1
    f32 = precompute_rel_biases(tm.pretrained, window)
    bf16 = precompute_rel_biases(tm.pretrained, window, torch.bfloat16)
    assert len(bf16) == SMALL["depth"]
    for a, b in zip(f32, bf16):
        assert b.dtype == torch.bfloat16
        assert b.shape == (1, SMALL["num_heads"], n, n)
        assert bias_row_stride(b) == -(-n // 16) * 16
        assert not b.is_contiguous() or n % 16 == 0
        torch.testing.assert_close(b, a.to(torch.bfloat16), rtol=0, atol=0)


def test_relative_position_index_padded_matches_jax():
    """The padded index equals the JAX package's in its first N columns and
    indexes a real table entry in the pad columns."""
    from depthmap_tpu.models.beit import gen_relative_position_index as j_gen
    from depthmap_tpu_torch.models.beit import gen_relative_position_index
    for wh, ww in ((4, 6), (5, 5), (3, 7)):
        n = wh * ww + 1
        ld = -(-n // 16) * 16
        got = gen_relative_position_index(wh, ww, ld=ld).numpy()
        assert got.shape == (n, ld)
        np.testing.assert_array_equal(got[:, :n], j_gen(wh, ww))
        assert (got[:, n:] == 0).all()
        np.testing.assert_array_equal(
            gen_relative_position_index(wh, ww).numpy(), j_gen(wh, ww))


def test_weights_round_trip():
    """convert_dpt_beit(state_dict_from_jax(v)) reproduces v exactly and
    uses every key."""
    from depthmap_tpu.models.convert import SDict, convert_dpt_beit
    variables = jax_small_variables(seed=10)
    sd = SDict(state_dict_from_jax(variables))
    back = convert_dpt_beit(sd, depth=SMALL["depth"])
    assert sd.unused() == []
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))


def test_strict_checkpoint_load(tmp_path):
    """A checkpoint in the reference layout, classifier keys included,
    loads with strict=True."""
    src = init_random_(torch_small_module(), seed=3)
    sd = dict(src.state_dict())
    sd["pretrained.model.head.weight"] = torch.zeros(10, 64)
    sd["pretrained.model.fc_norm.weight"] = torch.ones(64)
    path = tmp_path / "dpt_beit_large_512.pt"
    torch.save(sd, path)
    dst = torch_small_module()
    load_checkpoint(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_full_width_layout_matches_converter():
    """The full dpt_beit_large_512 module names exactly the keys
    convert_dpt_beit reads (plus the converter-skipped buffers)."""
    from depthmap_tpu.models.convert import SDict, convert_dpt_beit
    with torch.device("meta"):     # shapes only, no memory
        m = build_model(1).module
    s = SDict({k: np.broadcast_to(np.float32(0), tuple(v.shape))
               for k, v in m.state_dict().items()})
    params = convert_dpt_beit(s, depth=24)["params"]
    assert s.unused() == []
    qkv = params["backbone"]["block_23"]["attn"]["qkv"]["kernel"]
    assert qkv.shape == (1024, 3072)


def test_tiling_mode_matches_jax():
    """Circular padding in every padded conv (the JAX package switches a
    module-global flag; the port sets it on the built model)."""
    from depthmap_tpu.models import layers as jlayers
    from depthmap_tpu_torch.models.layers import set_tiling_mode
    variables = jax_small_variables(seed=12)
    x = np.random.default_rng(13).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jlayers.set_tiling_mode(True)
    try:
        want = np.asarray(jax_small_module().apply(variables,
                                                   jnp.asarray(x)))
    finally:
        jlayers.set_tiling_mode(False)
    tm = torch_small_module(variables)
    set_tiling_mode(tm, True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        set_tiling_mode(tm, False)
        plain = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(plain - got).max() > 10 * ATOL   # the padding mattered


def test_relative_position_index_matches_jax():
    from depthmap_tpu.models.beit import gen_relative_position_index as jidx
    from depthmap_tpu_torch.models.beit import gen_relative_position_index
    for wh, ww in ((1, 1), (4, 4), (3, 7), (32, 56)):
        np.testing.assert_array_equal(
            gen_relative_position_index(wh, ww).numpy(), jidx(wh, ww))
