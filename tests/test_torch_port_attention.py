"""Kernel K1 (depthmap_tpu_torch/ops/flash_attention.py).

On the CPU: the plain version against the JAX package's ``attention_xla``
and its Pallas ``flash_attention`` in interpret mode, on the cases of
tests/test_flash_attention.py and at the BEiT head dim D = 64, to 2e-4 in
f32 (the bound the JAX kernel is held to).  The CUDA kernel against the
plain version is in tests/test_torch_port_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depthmap_tpu.models.attention import attention_xla
from depthmap_tpu.ops.flash_attention import flash_attention as j_flash
from depthmap_tpu_torch.models.attention import attention
from depthmap_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(rng, b=1, h=2, n=100, d=32, nk=None):
    nk = n if nk is None else nk
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    return q, k, v


def _plain(q, k, v, bias=None, scale=None):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = torch.from_numpy(bias) if bias is not None else None
    return fa.flash_attention_plain(*t, bias=tb, scale=scale).numpy()


def _jax_both(q, k, v, bias=None, scale=None):
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jb = jnp.asarray(bias) if bias is not None else None
    return (np.asarray(attention_xla(jq, jk, jv, jb, scale)),
            np.asarray(j_flash(jq, jk, jv, bias=jb, scale=scale,
                               interpret=True)))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [64, 128, 100, 257])
def test_plain_matches_jax_no_bias(rng, n, d):
    q, k, v = _qkv(rng, n=n, d=d)
    got = _plain(q, k, v)
    for want in _jax_both(q, k, v):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_jax_shared_bias(rng, d):
    n = 130
    q, k, v = _qkv(rng, n=n, d=d)
    bias = rng.normal(size=(1, 2, n, n)).astype(np.float32)
    got = _plain(q, k, v, bias)
    for want in _jax_both(q, k, v, bias):
        np.testing.assert_allclose(got, want, **TOL)


def test_plain_matches_jax_batched_bias(rng):
    n = 96
    q, k, v = _qkv(rng, b=2, n=n, d=64)
    bias = rng.normal(size=(2, 2, n, n)).astype(np.float32)
    got = _plain(q, k, v, bias)
    for want in _jax_both(q, k, v, bias):
        np.testing.assert_allclose(got, want, **TOL)


def test_plain_head_bias_promoted(rng):
    """(H, N, Nk) bias is one shared across the batch."""
    n = 40
    q, k, v = _qkv(rng, b=2, n=n, d=64)
    bias = rng.normal(size=(2, n, n)).astype(np.float32)
    got = _plain(q, k, v, bias)
    want, _ = _jax_both(q, k, v, bias[None])
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_custom_scale(rng):
    q, k, v = _qkv(rng, n=64)
    got = _plain(q, k, v, scale=0.25)
    for want in _jax_both(q, k, v, scale=0.25):
        np.testing.assert_allclose(got, want, **TOL)


def test_plain_cross_attention(rng):
    """N_q != N_k, with a bias."""
    q, k, v = _qkv(rng, n=33, nk=70, d=64)
    bias = rng.normal(size=(1, 2, 33, 70)).astype(np.float32)
    want, _ = _jax_both(q, k, v, bias)
    np.testing.assert_allclose(_plain(q, k, v, bias), want, **TOL)


def test_dispatch_cpu_runs_plain(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, n=50, d=64))
    before = fa.flash_attention_cuda.launches
    out = attention(q, k, v)
    assert fa.flash_attention_cuda.launches == before
    np.testing.assert_array_equal(
        out.numpy(), fa.flash_attention_plain(q, k, v).numpy())


def test_cuda_wrapper_rejects_cpu_tensors(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, n=16, d=64))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("n,nk,bias_batch", [(130, 130, 1), (100, 100, 2),
                                             (33, 70, 1), (1, 1, 1)])
def test_plain_padded_bias_matches_dense_and_jax(rng, n, nk, bias_batch):
    """A bias in K1's padded-row layout (the [..., :Nk] view of rows padded
    to 16 elements) gives the dense result and the JAX one."""
    q, k, v = _qkv(rng, b=2, n=n, nk=nk, d=64)
    bias = rng.normal(size=(bias_batch, 2, n, nk)).astype(np.float32)
    padded = fa.pad_bias_rows(torch.from_numpy(bias))
    assert padded.stride(2) % 16 == 0 and padded.stride(2) >= nk
    assert fa.bias_row_stride(padded) == padded.stride(2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = fa.flash_attention_plain(*t, bias=padded).numpy()
    np.testing.assert_array_equal(got, _plain(q, k, v, bias))
    for want in _jax_both(q, k, v, bias):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_layout_check(dtype):
    """The wrapper's layout check: a dense N = 1025 bias (rows of 2050 or
    4100 bytes) raises, its pad_bias_rows copy passes with the padded row
    stride, and so does a dense bias whose rows are already a multiple of
    16 elements."""
    dense = torch.zeros(1, 2, 1025, 1025, dtype=dtype)
    with pytest.raises(ValueError, match="padded"):
        fa.bias_row_stride(dense)
    assert fa.bias_row_stride(fa.pad_bias_rows(dense)) == 1040
    assert fa.bias_row_stride(torch.zeros(2, 2, 64, 64, dtype=dtype)) == 64
    with pytest.raises(ValueError):   # every other head: not packed
        fa.bias_row_stride(
            fa.pad_bias_rows(torch.zeros(1, 4, 64, 70, dtype=dtype))[:, ::2])
    with pytest.raises(ValueError):
        fa.bias_row_stride(fa.pad_bias_rows(
            torch.zeros(1, 2, 64, 64, dtype=dtype)).transpose(2, 3))


def test_attention_casts_bias_into_padded_layout(rng):
    """attention() passes a bias in q's dtype through as it is, and casts
    one in another dtype into a padded-row copy."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, n=40, d=64))
    bias = torch.from_numpy(rng.normal(size=(1, 2, 40, 40)).astype(
        np.float32))
    got = attention(q, k, v, bias=bias)
    want = fa.flash_attention_plain(q, k, v,
                                    fa.pad_bias_rows(bias, torch.bfloat16))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cast = fa.pad_bias_rows(bias, torch.bfloat16)
    assert cast.dtype == torch.bfloat16 and cast.stride(2) == 48
    torch.testing.assert_close(cast, bias.to(torch.bfloat16), rtol=0,
                               atol=0)
