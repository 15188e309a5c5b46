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
