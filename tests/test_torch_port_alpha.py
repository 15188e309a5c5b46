"""K1's online-softmax rescale alpha, restated on the CPU in numpy f32.

Each kv tile rescales the running output and row sum by alpha = 2^(m_old
log2e - m_new log2e).  The kernel's bodies compute the tile's exponents as
ex2(x log2e + nml) with nml = -(m_new log2e) rounded to f32.  Taking alpha
as ex2(m_old log2e + nml) (one FMA, as the bf16 body did) leaves the
rounding of nml in it: alpha != 1 while the max holds, so every later tile
reweights the earlier ones by the same factor, a one-signed drift that
grows with the number of tiles.  From the difference of the maxima,
ex2((m_old - m_new) log2e), alpha is exactly 1 while the max holds, as
the reference's exp2(m_prev - m_next) is.  Both CUDA bodies
(csrc/flash_attention.cu) take that form; the card checks the drift at
N = 10,765 (chip_smoke.py phase 2, tests/test_torch_port_cuda.py).
"""
from __future__ import annotations

import os

import numpy as np

LOG2E = np.float32(1.4426950408889634)
CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "depthmap_tpu_torch", "csrc", "flash_attention.cu")


def _fma_f32(a, b, c):
    """fmaf: a.b + c rounded once to f32 (the f32 product is exact in f64,
    and so is the sum here, where c cancels the product to a rounding
    error)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _nml(m):
    return (-LOG2E * m).astype(np.float32)


def alpha_one_fma(m_old, m_new):
    return np.exp2(_fma_f32(m_old, LOG2E, _nml(m_new))).astype(np.float32)


def alpha_from_difference(m_old, m_new):
    return np.exp2(((m_old - m_new) * LOG2E).astype(np.float32)).astype(
        np.float32)


def _maxima():
    rng = np.random.default_rng(0)
    return np.concatenate([
        (rng.normal(size=20000) * 16).astype(np.float32),
        np.arange(-400, 400, dtype=np.float32) / 8,   # bf16 logits / 8
    ])


def test_old_alpha_is_not_one_while_the_max_holds():
    m = _maxima()
    a = alpha_one_fma(m, m)
    off = a != 1
    assert off.mean() > 0.5
    # 1 +- a few f32 ulps: ~6e-7 at the logit 11.25 the card check uses
    assert np.abs(a - 1).max() < 1e-5
    assert alpha_one_fma(np.float32(11.25), np.float32(11.25)) != 1


def test_new_alpha_is_one_while_the_max_holds():
    m = _maxima()
    assert (alpha_from_difference(m, m) == 1).all()
    # a new max still rescales, as the reference's exp2 does (m + 1 is
    # rounded to f32: up to 8e-6 off at |m| near 70)
    up = m + np.float32(1)
    np.testing.assert_allclose(alpha_from_difference(m, up), np.exp(-1.0),
                               rtol=2e-5)
    assert alpha_from_difference(np.float32(-np.inf), np.float32(3)) == 0


def test_old_alpha_drifts_one_signed_over_the_tiles():
    """The output of a row whose max is in its first tile, with v rising
    over the keys: tile by tile in f32 with each alpha, against f64.  The
    old form's error is one-signed and far above the new form's."""
    rng = np.random.default_rng(1)
    n_tiles, rows = 169, 64
    s = (rng.normal(size=(rows, 64 * n_tiles)) * 1.5).astype(np.float32)
    s[:, 0] = 11.25                                       # the row max
    v = np.linspace(-1, 1, s.shape[1]).astype(np.float32)
    p64 = np.exp(s.astype(np.float64) - 11.25)
    want = (p64 * v).sum(1) / p64.sum(1)
    err = {}
    for name, form in (("old", alpha_one_fma), ("new", alpha_from_difference)):
        m = np.full(rows, -np.inf, np.float32)
        o = np.zeros(rows, np.float32)
        ell = np.zeros(rows, np.float32)
        for t in range(n_tiles):
            x = s[:, 64 * t:64 * (t + 1)]
            m_new = np.maximum(m, x.max(1))
            alpha = np.where(np.isneginf(m), np.float32(0), form(m, m_new))
            p = np.exp2(_fma_f32(x, LOG2E, _nml(m_new)[:, None]))
            o = (o * alpha + (p * v[64 * t:64 * (t + 1)]).sum(1,
                 dtype=np.float32)).astype(np.float32)
            ell = (ell * alpha + p.sum(1, dtype=np.float32)).astype(
                np.float32)
            m = m_new
        err[name] = o / ell - want
    assert np.abs(err["new"].mean()) * 10 < np.abs(err["old"].mean())
    assert (np.sign(err["old"]) == np.sign(err["old"].mean())).mean() > 0.9


def test_both_kernel_bodies_take_alpha_from_the_maxima():
    src = open(CU).read()
    assert src.count("ex2((m[hh] - m_use) * LOG2E)") == 2
    assert "ex2(fmaf(m[hh], LOG2E" not in src
