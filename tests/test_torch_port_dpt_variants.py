"""The two DPT variants the JAX ``build_dpt`` keeps beside the zoo's:
beitb16_384 (BEiT-B 384: 12 blocks, 768 wide, 12 heads, hooks (2, 5, 8,
11), reassemble (96, 192, 384, 768)) and vitb16_384 (ViT-B/16 at 384, the
same widths), at full width on the port against the JAX package.

Each full-width module runs at 384^2 on the CPU with the JAX module's
weights, drawn with numpy from a seed and carried into the port with
``state_dict_from_jax``: bound atol 3e-3, rtol 1e-3 in f32, the bound of
tests/test_torch_port_model.py.  Built on the meta device, each names
exactly the keys of its converter, and the converted tree has the JAX
module's shapes.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models import convert as C
from depthmap_tpu.models.dpt import build_dpt as j_build_dpt
from depthmap_tpu_torch.models.dpt import build_dpt
from depthmap_tpu_torch.models.weights import state_dict_from_jax

ATOL, RTOL = 3e-3, 1e-3
CONVERTERS = {"beitb16_384": functools.partial(C.convert_dpt_beit, depth=12),
              "vitb16_384": functools.partial(C.convert_dpt_vit, depth=12)}


def _jax_variables(variant: str, seed: int):
    """The JAX module's variables, every leaf redrawn from a numpy
    generator: kernels ~ N(0, 1/fan_in), norm scales and gammas near 1,
    biases small and positive (so the ReLU head does not die), rel-pos
    tables large enough to shape the attention."""
    shapes = jax.eval_shape(j_build_dpt(variant).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 384, 384, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "gamma_1", "gamma_2"):
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "relative_position_bias_table":
            return 0.5 * rng.normal(size=shape)
        if name == "bias":
            return 0.05 + 0.05 * rng.random(size=shape)
        return 0.1 * rng.normal(size=shape)
    out = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


@pytest.mark.parametrize("variant", sorted(CONVERTERS))
def test_variant_matches_jax_at_384(variant):
    variables = _jax_variables(variant, seed=11)
    x = np.random.default_rng(12).normal(size=(1, 384, 384, 3)).astype(
        np.float32)
    want = np.asarray(j_build_dpt(variant).apply(variables, jnp.asarray(x)))
    m = build_dpt(variant)
    m.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (1, 384, 384)
    assert np.ptp(want) > 0.1       # a live, non-constant map
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", sorted(CONVERTERS))
def test_variant_layout_matches_converter(variant):
    from depthmap_tpu.models.convert import SDict
    with torch.device("meta"):     # shapes only, no memory
        m = build_dpt(variant)
    s = SDict({k: np.broadcast_to(np.float32(0), tuple(v.shape))
               for k, v in m.state_dict().items()})
    conv = CONVERTERS[variant](s)
    assert s.unused() == []
    jshapes = jax.eval_shape(j_build_dpt(variant).init,
                             jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    got = {jax.tree_util.keystr(p): np.shape(v) for p, v in
           jax.tree_util.tree_leaves_with_path(conv)}
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_leaves_with_path(jshapes)}
    assert got == want
