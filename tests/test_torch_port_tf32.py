"""K1's f32 body computes in split TF32; the check that tells it from one
TF32 pass.

The CUDA kernel's f32 body takes each product as three TF32 passes, hi.hi
+ hi.lo + lo.hi with x = hi + lo (hi = x rounded to TF32, lo = x - hi
rounded to TF32).  Restated here in plain torch on the CPU, on the inputs
chip_smoke.py's phase 2 draws (q ~ 4 N(0, 1), k ~ N(0, 1), v ~ N(0, 1) / 4,
D = 64) at small Marigold-like shapes: the split product stays within
F32_ACCURACY (5e-5) of ``flash_attention_plain``, one TF32 pass does not,
and the plain version agrees with the JAX package's Pallas kernel in
interpret mode to 2e-4, the bound the JAX kernel is held to in f32.  The
kernel itself is held to the same F32_ACCURACY on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phase 2).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depthmap_tpu.ops.flash_attention import flash_attention as j_flash
from depthmap_tpu_torch.ops import flash_attention as fa

F32_ACCURACY = 5e-5
JAX_TOL = dict(rtol=2e-4, atol=2e-4)

# name: (B, H, N, Nk, bias): Marigold's self-attention, its cross-attention
# on the 77 keys of the empty prompt, and a shared bias as BEiT / ZoeDepth
# give it (N = 130: a ragged tile of 2 keys)
CASES = {
    "self_160": (1, 5, 160, 160, False),
    "cross_160x77": (1, 5, 160, 77, False),
    "bias_130": (1, 4, 130, 130, True),
}


def _inputs(case, seed=0):
    b, h, n, nk, with_bias = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, n, 64)) * 4.0).astype(np.float32)
    k = rng.normal(size=(b, h, nk, 64)).astype(np.float32)
    v = (rng.normal(size=(b, h, nk, 64)) * 0.25).astype(np.float32)
    bias = rng.normal(size=(1, h, n, nk)).astype(np.float32) \
        if with_bias else None
    return q, k, v, bias


def _split(x):
    hi = fa.round_to_tf32(x)
    return hi, fa.round_to_tf32(x - hi)


def _tf32_matmul(a, b, passes):
    """a @ b on TF32 operands with f32 sums: one pass (hi.hi) or the
    kernel's three, small terms first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_attention(q, k, v, bias, passes):
    """The kernel's arithmetic: both products in TF32 passes, the softmax
    in f32."""
    s = _tf32_matmul(q, k.transpose(-1, -2), passes) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _tf32_matmul(p, v, passes) / p.sum(-1, keepdim=True)


def _torch(*arrays):
    return [torch.from_numpy(a) if a is not None else None for a in arrays]


def test_round_to_tf32_is_round_to_nearest_on_11_bits():
    """Against frexp: 11 significant bits, ties away from zero; the low 13
    bits clear; inf and nan pass through."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000),
        np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(-8, 9),
    ]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5), e - 11)
    got = fa.round_to_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = fa.round_to_tf32(special)
    assert out[0] == float("inf") and out[1] == -float("inf")
    assert torch.isnan(out[2])


@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_product_holds_f32_accuracy(case):
    q, k, v, bias = _torch(*_inputs(case))
    want = fa.flash_attention_plain(q, k, v, bias)
    got = _tf32_attention(q, k, v, bias, passes=3)
    err = (got - want).abs().max().item()
    assert err <= F32_ACCURACY, err


@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_pass_breaks_the_f32_bound(case):
    """Both ways a body could drop to one pass: the products on TF32
    operands, and the fault the card checks plant (the plain version on q,
    k, v rounded to TF32)."""
    q, k, v, bias = _torch(*_inputs(case))
    want = fa.flash_attention_plain(q, k, v, bias)
    r = fa.round_to_tf32
    for got in (_tf32_attention(q, k, v, bias, passes=1),
                fa.flash_attention_plain(r(q), r(k), r(v), bias)):
        err = (got - want).abs().max().item()
        assert err > F32_ACCURACY, err


@pytest.mark.parametrize("case", list(CASES))
def test_plain_f32_matches_jax_flash_attention(case):
    q, k, v, bias = _inputs(case)
    got = fa.flash_attention_plain(*_torch(q, k, v, bias)).numpy()
    jb = jnp.asarray(bias) if bias is not None else None
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bias=jb, interpret=True))
    np.testing.assert_allclose(got, want, **JAX_TOL)
