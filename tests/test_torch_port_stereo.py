"""The warp stereo fills ("none", "naive", "naive_interpolating") of the
port (depthmap_tpu_torch/ops/stereo.py) against the JAX package's, byte
for byte, on the CPU.

The JAX package runs "naive_interpolating" one eye at a time through its
host C++ fill (the port through its single-pass version) and the batched
path through the single-pass XLA fill; both are held here.

Exponents: torch and XLA take x^1 and x^2 as exact, so their offsets agree
to the bit.  At other exponents the two pow implementations differ in the
last bit of nd^e for 1-2% of the 65,536 levels of a 16-bit map (25% at
3.0, which torch takes as x*x*x); the truncated offset moves only where
nd^e * divergence + separation lies within that bit of an integer, and on
every level, at the divergences held here, it does not: the bound asserted
is 0 differing pixels.  The card against the CPU is in
tests/test_torch_port_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depthmap_tpu.ops import stereo as J
from depthmap_tpu_torch.ops import stereo as T
from tests import oracles

WARP = ("none", "naive", "naive_interpolating")


def _depths(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (0.5 + 0.5 * np.sin(xx / 7.0) * np.cos(yy / 5.0)) * 65535
    return {"random": (rng.random((h, w)) * 65535).astype(np.uint16),
            "smooth": smooth.astype(np.uint16)}


@pytest.mark.parametrize("fill", WARP)
@pytest.mark.parametrize("exponent", [1.0, 2.0, 1.7])
@pytest.mark.parametrize("balance", [-0.5, 0.0, 0.7])
def test_warp_fills_match_jax(rng, fill, exponent, balance):
    """Both eyes through create_stereoimages, at +-divergence, with and
    without separation, on a random and a smooth depth map."""
    h, w = 10, 120
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    for kind, depth in _depths(rng, h, w).items():
        for div, sep in ((3.0, 0.0), (-3.0, 0.0), (2.5, 0.8), (-4.0, -1.1)):
            want = J.create_stereoimages(img, depth, div, sep, ["left-right"],
                                         balance, exponent, fill)
            got = T.create_stereoimages(img, depth, div, sep, ["left-right"],
                                        balance, exponent, fill,
                                        device="cpu")
            np.testing.assert_array_equal(
                got[0], np.asarray(want[0]),
                err_msg=f"{kind} div={div} sep={sep}")


@pytest.mark.parametrize("fill", WARP)
def test_warp_fills_all_modes_match_jax(rng, fill):
    h, w = 8, 64
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depth = (rng.random((h, w)) * 65535).astype(np.uint16)
    modes = list(T.STEREO_MODES)
    want = J.create_stereoimages(img, depth, 2.5, 0.3, modes, 0.2, 1.0, fill)
    got = T.create_stereoimages(img, depth, 2.5, 0.3, modes, 0.2, 1.0, fill,
                                device="cpu")
    assert len(got) == len(want) == 8
    for m, g, wnt in zip(modes, got, want):
        assert g.dtype == np.uint8, m
        np.testing.assert_array_equal(g, np.asarray(wnt), err_msg=m)


@pytest.mark.parametrize("fill", WARP)
def test_one_eye_matches_jax_and_oracle(rng, fill):
    """apply_stereo_divergence on one eye against the JAX function and the
    reference's loops (tests/oracles.py), a flat map included (normalized
    depth NaN: every offset converts to 0, as in XLA)."""
    h, w = 12, 80
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depths = _depths(rng, h, w)
    depths["flat"] = np.full((h, w), 1234, np.uint16)
    for kind, depth in depths.items():
        for div, sep, expo in ((4.0, 0.0, 1.0), (-6.0, 1.5, 2.0)):
            want = np.asarray(J.apply_stereo_divergence(img, depth, div, sep,
                                                        expo, fill))
            got = T.apply_stereo_divergence(
                torch.from_numpy(img), torch.from_numpy(depth), div, sep,
                expo, fill).numpy()
            np.testing.assert_array_equal(got, want, err_msg=kind)
            if kind != "flat":
                nd = np.asarray(J.normalize_depth(jnp.asarray(depth)),
                                np.float64)
                np.testing.assert_array_equal(got, oracles.stereo_warp_naive(
                    img, nd, div / 100 * w, sep / 100 * w, expo, fill))


@pytest.mark.parametrize("exponent", [1.7, 0.5, 3.0])
def test_warp_non_integer_exponent_every_level_matches_jax(exponent):
    """At exponents where torch's and XLA's pow differ in the last bit, one
    eye over every level of a 16-bit map (each level once, shuffled, in a
    128 x 512 map) is byte-equal to the JAX package's, at +-24 px.  The
    image encodes each source column, so an offset that moved would show
    in the "none" eye wherever its pixel is seen."""
    depth = np.random.default_rng(12).permutation(
        np.arange(65536, dtype=np.uint16)).reshape(128, 512)
    cols = np.arange(512)
    img = np.stack([np.broadcast_to(cols & 255, depth.shape),
                    np.broadcast_to(cols >> 8, depth.shape),
                    np.broadcast_to(np.arange(128)[:, None], depth.shape)],
                   -1).astype(np.uint8)
    for fill in ("none", "naive_interpolating"):
        for div, sep in ((4.7, 0.3), (-4.7, -0.3)):
            want = np.asarray(J.apply_stereo_divergence(img, depth, div, sep,
                                                        exponent, fill))
            got = T.apply_stereo_divergence(
                torch.from_numpy(img), torch.from_numpy(depth), div, sep,
                exponent, fill).numpy()
            ndiff = int((got != want).any(-1).sum())
            assert ndiff == 0, (fill, div, sep, ndiff)


@pytest.mark.parametrize("fill", WARP)
def test_stereo_pair_batch_matches_jax(rng, fill):
    h, w = 6, 48
    imgs = (rng.random((3, h, w, 3)) * 255).astype(np.uint8)
    nds = rng.random((3, h, w)).astype(np.float32)
    args = (5.0, -5.0, -0.7, 0.7, 1.0, fill)
    jl, jr = J.stereo_pair_batch(jnp.asarray(imgs), jnp.asarray(nds), *args)
    tl, tr = T.stereo_pair_batch(torch.from_numpy(imgs),
                                 torch.from_numpy(nds), *args)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    only_l = T.stereo_pair_batch(torch.from_numpy(imgs),
                                 torch.from_numpy(nds), *args,
                                 make_right=False)
    assert torch.equal(only_l[0], tl) and torch.equal(
        only_l[1], torch.from_numpy(imgs))


def test_interpolating_adversarial_near_black(rng):
    """Near-black images (most pixels sum to 0, black borders) against the
    canonical sequential sweep (tests/oracles.py) and the JAX batched fill,
    as tests/test_stereo.py pins the JAX one."""
    h, w = 6, 48
    for trial in range(30):
        scale = [1, 2, 3, 255][trial % 4]
        imgs = (rng.random((2, h, w, 3)) * scale).astype(np.uint8)
        nds = rng.random((2, h, w)).astype(np.float32)
        div_px = [20.0, -20.0, 40.0][trial % 3]
        args = (div_px, -div_px, 0.0, 0.0, 1.0, "naive_interpolating")
        left, right = T.stereo_pair_batch(torch.from_numpy(imgs),
                                          torch.from_numpy(nds), *args)
        jl, jr = J.stereo_pair_batch(jnp.asarray(imgs), jnp.asarray(nds),
                                     *args)
        np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(right.numpy(), np.asarray(jr))
        for i in range(2):
            np.testing.assert_array_equal(
                left[i].numpy(), oracles.stereo_warp_naive(
                    imgs[i], nds[i], div_px, 0.0, 1.0,
                    "naive_interpolating"))


def test_unknown_fill_raises():
    img = torch.zeros((4, 8, 3), dtype=torch.uint8)
    depth = torch.arange(32).reshape(4, 8)
    with pytest.raises(ValueError, match="Unknown fill"):
        T.apply_stereo_divergence(img, depth, 2.5, 0.0, 1.0, "bogus")
    with pytest.raises(ValueError, match="Unknown warp fill"):
        T.apply_stereo_divergence_naive(img, depth.float(), 1.0, 0.0, 1.0,
                                        "polylines_sharp")


@pytest.mark.parametrize("fill", T.FILL_TECHNIQUES)
def test_tensor_inputs_equal_the_numpy_route(rng, fill):
    """create_stereoimages on the photo and the uint16 map given as tensors,
    and stereoimages_to_host (the photo a host tensor, the map on the
    device, the results through HostCopies), give the numpy route's bytes
    in all 8 modes."""
    h, w = 8, 64
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depth = (rng.random((h, w)) * 65535).astype(np.uint16)
    modes = list(T.STEREO_MODES)
    args = (2.5, 0.3, modes, 0.2, 1.0, fill)
    want = T.create_stereoimages(img, depth, *args, device="cpu")
    tensors = T.create_stereoimages(torch.from_numpy(img),
                                    torch.from_numpy(depth), *args)
    queued = T.stereoimages_to_host(torch.from_numpy(img),
                                    torch.from_numpy(depth), *args).arrays()
    assert len(want) == len(tensors) == len(queued) == 8
    for m, wnt, a, b in zip(modes, want, tensors, queued):
        assert a.dtype == b.dtype == np.uint8, m
        np.testing.assert_array_equal(a, wnt, err_msg=m)
        np.testing.assert_array_equal(b, wnt, err_msg=m)
