"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels have no CPU mode).  This file imports no JAX; without the
package's conftest (which sets JAX up) it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

K1 bounds (max abs error against the plain version, which computes in f32;
the bf16 cases run the tensor-core body, the f32 ones the CUDA-core body):
f32 5e-3, the bound the JAX package holds its TPU kernel to; bf16 2e-2,
about two bf16 ulps of the largest outputs (the output and p are rounded
to bf16, and a different f32 summation order can flip either rounding).
K2 is byte-exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from depthmap_tpu_torch.ops import flash_attention as fa
from depthmap_tpu_torch.ops import polylines as P


# case: (dtype, B, N, Nk, bias: None / "shared" / "batched", scale)
K1_CASES = {
    "bf16_shared_1025": (torch.bfloat16, 4, 1025, 1025, "shared", None),
    "bf16_shared_1793": (torch.bfloat16, 1, 1793, 1793, "shared", None),
    "bf16_batched_65": (torch.bfloat16, 2, 65, 65, "batched", None),
    "bf16_shared_n1": (torch.bfloat16, 2, 1, 1, "shared", None),
    "bf16_none_cross": (torch.bfloat16, 1, 77, 300, None, None),
    "bf16_masked_row": (torch.bfloat16, 2, 130, 130, "shared", None),
    "bf16_scale": (torch.bfloat16, 2, 200, 200, "batched", 0.3),
    "f32_batched_130": (torch.float32, 2, 130, 130, "batched", None),
    "f32_shared_1025": (torch.float32, 1, 1025, 1025, "shared", None),
    "f32_none_513": (torch.float32, 1, 513, 513, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_flash_attention_kernel_matches_plain(case):
    """Each bias in the padded-row layout the kernel reads (pad_bias_rows);
    bf16 runs the tensor-core body, f32 the CUDA-core body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(0)
    dt, b, n, nk, bias_kind, scale = K1_CASES[case]
    h, d = 16, 64
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dt)  # noqa: E731
    q, k, v = mk(b, h, n, d), mk(b, h, nk, d), mk(b, h, nk, d)
    bias = None
    if bias_kind:
        bias = fa.pad_bias_rows(
            mk(1 if bias_kind == "shared" else b, h, n, nk))
    if case == "bf16_masked_row":
        bias[:, :, 5] = float("-inf")
    got = fa.flash_attention_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias, scale)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (2e-2 if dt == torch.bfloat16 else 5e-3), err
    if case == "bf16_masked_row":
        assert torch.count_nonzero(got[:, :, 5]) == 0


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_a_dense_bias():
    """A dense N = 1025 bias (rows of 2050 bytes) is refused, not copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q = torch.zeros(1, 16, 1025, 64, dtype=torch.bfloat16, device="cuda")
    bias = torch.zeros(1, 16, 1025, 1025, dtype=torch.bfloat16,
                       device="cuda")
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="padded"):
        fa.flash_attention_cuda(q, q, q, bias)
    assert fa.flash_attention_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div", [24.0, -48.0])
def test_polylines_kernel_byte_exact(sharp, div):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(1)
    img = torch.randint(0, 256, (64, 480, 3), generator=g,
                        dtype=torch.uint8).cuda()
    nd = torch.rand((64, 480), generator=g, dtype=torch.float64).cuda()
    got = P.polylines_cuda(img, nd, div, 0.0, 1.0, sharp)
    torch.cuda.synchronize()
    want = P.polylines_plain(img, nd, div, 0.0, 1.0, sharp)
    assert torch.equal(got, want)


def _depth(kind: str, rows: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((rows, w))
    if kind == "flat":
        return np.full((rows, w), 0.5)
    if kind == "ties":   # quantized: many points share an exact x
        return rng.integers(0, 5, (rows, w)) / 4.0
    if kind == "beyond":   # far outside [0, 1]: points move 90x divergence
        return rng.random((rows, w)) * 90.0
    yy, xx = np.mgrid[0:rows, 0:w]
    return 0.5 + 0.5 * np.sin(xx / 7.0) * np.cos(yy / 5.0)


# case: (rows, w, channels, depth, divergence_px, separation_px, exponent,
# sharp).  over_32 and over_64 hold more active segments than a lane
# holds in registers (the spill slots); wide_sort sorts in device scratch
# (its points do not fit in shared memory); nd_beyond_1 moves points up to
# 90x further than |divergence| (hundreds of active segments).
K2_CASES = {
    "flat_sharp": (16, 480, 3, "flat", 24.0, 0.0, 1.0, True),
    "flat_soft": (16, 480, 3, "flat", -41.0, 0.0, 1.0, False),
    "structured": (24, 480, 3, "structured", 23.0, 0.0, 1.0, True),
    "ties": (16, 480, 3, "ties", 8.0, 0.0, 1.0, True),
    "sep_exp2": (16, 480, 3, "random", 20.0, 7.5, 2.0, True),
    "sep_exp05_soft": (16, 480, 3, "random", -20.0, -7.5, 0.5, False),
    "exp17": (16, 480, 3, "random", 20.0, 0.0, 1.7, True),
    "c1": (16, 480, 1, "random", 24.0, 0.0, 1.0, True),
    "c4_soft": (16, 480, 4, "random", -24.0, 0.0, 1.0, False),
    "over_32": (4, 1920, 3, "random", 200.0, 0.0, 1.0, True),
    "over_64": (2, 1920, 3, "random", -600.0, 0.0, 1.0, True),
    "over_32_soft": (4, 1920, 3, "random", -300.0, 0.0, 1.0, False),
    "w1": (8, 1, 3, "random", 0.4, 0.0, 1.0, True),
    "w2": (8, 2, 3, "random", -1.2, 0.0, 1.0, False),
    "w3": (8, 3, 4, "random", 1.9, 0.5, 1.0, True),
    "wide_sort": (2, 4200, 3, "random", 30.0, 0.0, 1.0, True),
    "nd_beyond_1": (4, 1920, 3, "beyond", 20.0, 0.0, 1.0, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
def test_polylines_kernel_byte_exact_cases(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rows, w, ch, kind, div, sep, expo, sharp = K2_CASES[case]
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (rows, w, ch),
                                        dtype=np.uint8)).cuda()
    nd = torch.from_numpy(_depth(kind, rows, w, 4)).cuda()
    before = (P._sort_cuda.launches, P._sweep_cuda.launches)
    got = P.polylines_cuda(img, nd, div, sep, expo, sharp)
    torch.cuda.synchronize()
    assert (P._sort_cuda.launches, P._sweep_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want = P.polylines_plain(img, nd, div, sep, expo, sharp)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("kind", ["ties", "random"])
def test_polylines_sort_stage_matches_stable_sort(sharp, kind):
    """Stage A's (x, start point) is torch.sort(stable=True) of the segment
    starts, ties included, and its segment fields are the points' own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rows, w, ch = 8, 480, 3
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.integers(0, 256, (rows, w, ch),
                                        dtype=np.uint8)).cuda()
    nd = torch.from_numpy(_depth(kind, rows, w, 5)).cuda()
    px, pd, pc = P._points(nd, w, 8.0, 1.5, 1.0, sharp)
    n_seg = px.shape[1] - 1
    sorted_, rgb, order = P._sort_cuda(img, nd, 8.0, 1.5, 1.0, sharp)
    torch.cuda.synchronize()
    want_x, want_o = torch.sort(px[:, :-1], dim=1, stable=True)
    if kind == "ties":
        assert bool((want_x[:, 1:] == want_x[:, :-1]).any())
    o = order[:, :n_seg].long()
    assert torch.equal(o, want_o)
    assert torch.equal(sorted_[0, :, :n_seg], want_x)
    assert torch.equal(sorted_[0, :, n_seg], px[:, -1])
    assert torch.equal(sorted_[1, :, :n_seg], px.gather(1, o + 1))
    assert torch.equal(sorted_[2, :, :n_seg], pd.gather(1, o))
    assert torch.equal(sorted_[3, :, :n_seg], pd.gather(1, o + 1))
    assert torch.equal(sorted_[4, :, :n_seg],
                       1.0 / (px.gather(1, o + 1) - want_x))
    ridx = torch.arange(rows, device="cuda")[:, None]
    left, right = img[ridx, pc[o]].long(), img[ridx, pc[o + 1]].long()
    packed = sum((left[..., k] << (8 * k)) | (right[..., k] << (8 * (4 + k)))
                 for k in range(ch))
    assert torch.equal(rgb[:, :n_seg], packed)


def _host_sweep(x0, x1, d0, d1, o, img, w, sharp):
    """The host kernel's sweep (depthmap_tpu/native/polylines.cpp:67-130)
    on given sorted segments of one row: x0 (n_seg + 1,) with the last
    point, x1, d0, d1, o (n_seg,); img (W, C) -> (W, C) uint8."""
    n_pt = 2 * w + 2 if sharp else w + 2
    n_seg = n_pt - 1

    def pcol(q):
        if q == 0:
            return 0
        if q == n_pt - 1:
            return w - 1
        return (q - 1) >> 1 if sharp else q - 1

    img = img.tolist()
    out = np.zeros((w, len(img[0])), np.uint8)
    active, ptr, pt = [], 0, 0
    for col in range(w):
        color = [0.5] * len(img[0])
        while x0[pt] < col:
            pt += 1
        pt -= 1
        while x0[pt] < col + 1:
            cf = (x0[pt] if col < x0[pt] else float(col)) + 1e-7
            ct = (x0[pt + 1] if x0[pt + 1] < col + 1.0 else col + 1.0) - 1e-7
            sig = ct - cf
            xc = cf + 0.5 * sig
            while ptr < n_seg and x0[ptr] < xc:
                active.append(ptr)
                ptr += 1
            i = 0
            while i < len(active):
                if x1[active[i]] < xc:
                    active[i] = active[-1]
                    active.pop()
                else:
                    i += 1
            best = active[0] if active else -1
            if len(active) != 1:
                top = -1e-7
                for s in active:
                    ip = (xc - x0[s]) / (x1[s] - x0[s])
                    cl = (1.0 - ip) * d0[s] + ip * d1[s]
                    if top < cl and 0.0 < ip < 1.0:
                        top, best = cl, s
            if best >= 0:
                left, right = pcol(o[best]), pcol(o[best] + 1)
                ip = (xc - x0[best]) / (x1[best] - x0[best])
                for k in range(len(color)):
                    if left == right:
                        color[k] += img[left][k] * sig
                    else:
                        color[k] += (img[left][k] * (1.0 - ip)
                                     + img[right][k] * ip) * sig
            pt += 1
        out[col] = [0 if v < 0 else (255 if v > 255 else int(v))
                    for v in color]
    return out


def _synthetic_segments(rng, rows, w, ch, sharp, span):
    """Sorted segments as stage A lays them out, made up so that exact
    ties of closeness happen: starts on a 1/8 grid (equal starts), lengths
    up to span (10% reversed), closeness 0, 1 or 2 and mostly constant.
    Returns image, sorted, rgb, order (numpy) and the host loop's eye."""
    n_seg = 2 * w + 1 if sharp else w + 1
    n_pt = n_seg + 1
    stride = (n_seg + 1 + 31) // 32 * 32
    img = rng.integers(0, 256, (rows, w, ch), dtype=np.uint8)
    sorted_ = np.zeros((5, rows, stride))
    order = np.zeros((rows, stride), np.int32)
    rgb = np.zeros((rows, stride), np.int64)
    want = np.zeros_like(img)
    levels = np.array([0.0, 1.0, 2.0])
    for r in range(rows):
        x0 = np.sort(np.floor((rng.random(n_seg) * 1.04 - 0.02) * w * 8) / 8)
        x0[0] = -1.0 * w
        x1 = x0 + np.where(rng.random(n_seg) < 0.1, -0.5,
                           np.floor(rng.random(n_seg) * span * 8 + 1) / 8)
        x1[0] = x0[1] + 0.125
        d0 = levels[rng.integers(0, 3, n_seg)]
        d1 = np.where(rng.random(n_seg) < 0.7, d0,
                      levels[rng.integers(0, 3, n_seg)])
        o = rng.integers(0, n_pt - 1, n_seg)
        left = np.where(o == 0, 0, (o - 1) >> 1 if sharp else o - 1)
        right = np.where(o + 1 == n_pt - 1, w - 1, o >> 1 if sharp else o)
        sorted_[:, r, :n_seg] = [x0, x1, d0, d1, 1.0 / (x1 - x0)]
        sorted_[0, r, n_seg] = 2.0 * w
        order[r, :n_seg] = o
        rgb[r, :n_seg] = sum(
            (img[r, left, k].astype(np.int64) << (8 * k))
            | (img[r, right, k].astype(np.int64) << (8 * (4 + k)))
            for k in range(ch))
        want[r] = _host_sweep(sorted_[0, r].tolist(), x1.tolist(),
                              d0.tolist(), d1.tolist(), o.tolist(), img[r],
                              w, sharp)
    return img, sorted_, rgb, order, want


@pytest.mark.cuda
@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("span", [2.0, 12.0, 60.0])
def test_polylines_sweep_stage_breaks_ties_as_the_host_loop(sharp, span):
    """Real depth maps almost never give two candidate segments exactly the
    same closeness, so the sweep alone runs here on synthetic sorted
    segments whose closeness is mostly constant: exact ties at most steps,
    equal starts, reversed segments, and (span 12, 60) more than 32 and 64
    active segments.  Byte-exact against the host kernel's loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rows, w, ch = 3, 90, 3
    img, sorted_, rgb, order, want = _synthetic_segments(
        np.random.default_rng(7), rows, w, ch, sharp, span)
    got = P._sweep_cuda(torch.from_numpy(sorted_).cuda(),
                        torch.from_numpy(rgb).cuda(),
                        torch.from_numpy(order).cuda(), w, ch, sharp)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
