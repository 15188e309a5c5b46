"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels have no CPU mode).  This file imports no JAX; without the
package's conftest (which sets JAX up) it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

K1 bounds (max abs error against the plain version, which computes in f32;
the bf16 cases run the bf16 body, the f32 ones the split-TF32 body, both
on the tensor cores): f32 5e-3, the bound the JAX package holds its TPU
kernel to, and F32_ACCURACY (5e-5), f32 accuracy, which one TF32 pass
(1e-3 or more here) breaks; bf16 2e-2,
about two bf16 ulps of the largest outputs (the output and p are rounded
to bf16, and a different f32 summation order can flip either rounding).
q is drawn 4x and v 1/4x N(0, 1): the logits have std 4, so the softmax
is peaked and the outputs (up to ~1.4) stand far above the bound where a
kernel errs; each case also checks that the answers of planted faults (a
kv tile skipped, the output scaled by 0.8) break the bound, and for f32
that one TF32 pass (the plain version on q, k, v rounded to TF32) breaks
F32_ACCURACY.
K2 and the warp stereo fills are byte-exact.  Small Depth Anything, ViT
and hybrid DPT forwards in f32 on the card (K1 bias-free, TF32 off), small
ZoeDepth n / k / nk forwards (a BEiT core: K1 with a bias shared across
the flip-TTA batch), and the conv nets midas_v21 / midas_v21_small and
LeReS (no K1), hold to 1e-3 of the CPU map's range, the bound
chip_smoke.py holds the whole path to.  The normal
map on the card holds to its CPU twin within |d| <= 1 on <= 0.1% of the
bytes.  The 3D photo (plain torch on the card, no kernel of its own
beyond K1): the weighted median and the renderer's frames (triangles and
splat, tests/test_render.py's scene) equal the CPU's; the three
full-width inpainting nets hold to 1e-4 of the CPU output's range (f32,
TF32 off).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from depthmap_tpu_torch.ops import flash_attention as fa
from depthmap_tpu_torch.ops import polylines as P
from depthmap_tpu_torch.ops import stereo as S


# case: (dtype, B, H, N, Nk, bias: None / "shared" / "batched", scale).
# The bias-free cases at 6, 12 and 16 heads are Depth Anything's calls:
# v2 Small / Base / Large at N = 1025 (512^2 at net 448), 1370 (518^2),
# 1825 (1080p at net 448) and 10765 (1080p with net_size_match), with
# ragged last kv tiles at 1370, 1825 and 10765.  The MiDaS 3.0 ViTs (16
# heads for ViT-L, 12 for the hybrid's ViT-B) run N = 577 (a 24 x 24 grid:
# one key in the last kv tile) and 1009 (1080p at net 384: 42 x 24), and
# BEiT-384 N = 577 with a bias (rows padded to 592).  ZoeDepth's BEiT-384
# core runs under flip TTA, one bias shared across the doubled batch: N =
# 1025 at batch 8 and 1009 at batch 2 (n / nk), 2305 at batch 8 and 1345
# at batch 2 (k), and 769 in f32 (the numerics phase's 384 x 512 image);
# then Boost's and Marigold's calls.
K1_CASES = {
    "bf16_shared_1025": (torch.bfloat16, 4, 16, 1025, 1025, "shared", None),
    "bf16_shared_1793": (torch.bfloat16, 1, 16, 1793, 1793, "shared", None),
    "bf16_batched_65": (torch.bfloat16, 2, 16, 65, 65, "batched", None),
    "bf16_shared_n1": (torch.bfloat16, 2, 16, 1, 1, "shared", None),
    "bf16_none_cross": (torch.bfloat16, 1, 16, 77, 300, None, None),
    "bf16_masked_row": (torch.bfloat16, 2, 16, 130, 130, "shared", None),
    "bf16_scale": (torch.bfloat16, 2, 16, 200, 200, "batched", 0.3),
    "f32_batched_130": (torch.float32, 2, 16, 130, 130, "batched", None),
    "f32_batched_65": (torch.float32, 2, 16, 65, 65, "batched", None),
    "f32_shared_n1": (torch.float32, 2, 16, 1, 1, "shared", None),
    "f32_none_cross": (torch.float32, 1, 16, 77, 300, None, None),
    "f32_masked_row": (torch.float32, 2, 16, 130, 130, "shared", None),
    "f32_scale": (torch.float32, 2, 16, 200, 200, "batched", 0.3),
    "f32_shared_1025": (torch.float32, 1, 16, 1025, 1025, "shared", None),
    "f32_none_513": (torch.float32, 1, 16, 513, 513, None, None),
    "bf16_none_h12_b4_1025": (torch.bfloat16, 4, 12, 1025, 1025, None, None),
    "bf16_none_h6_1370": (torch.bfloat16, 2, 6, 1370, 1370, None, None),
    "bf16_none_h12_1825": (torch.bfloat16, 1, 12, 1825, 1825, None, None),
    "bf16_none_h16_1370": (torch.bfloat16, 1, 16, 1370, 1370, None, None),
    "bf16_none_h16_10765": (torch.bfloat16, 1, 16, 10765, 10765, None,
                            None),
    "f32_none_h12_1370": (torch.float32, 1, 12, 1370, 1370, None, None),
    "f32_none_h6_1825": (torch.float32, 1, 6, 1825, 1825, None, None),
    "bf16_none_h16_b4_577": (torch.bfloat16, 4, 16, 577, 577, None, None),
    "bf16_none_h16_1009": (torch.bfloat16, 1, 16, 1009, 1009, None, None),
    "bf16_none_h12_b4_577": (torch.bfloat16, 4, 12, 577, 577, None, None),
    "bf16_none_h12_1009": (torch.bfloat16, 1, 12, 1009, 1009, None, None),
    "bf16_shared_h16_577": (torch.bfloat16, 1, 16, 577, 577, "shared",
                            None),
    "bf16_shared_b8_1025": (torch.bfloat16, 8, 16, 1025, 1025, "shared",
                            None),
    "bf16_shared_b2_1009": (torch.bfloat16, 2, 16, 1009, 1009, "shared",
                            None),
    "bf16_shared_b8_2305": (torch.bfloat16, 8, 16, 2305, 2305, "shared",
                            None),
    "bf16_shared_b2_1345": (torch.bfloat16, 2, 16, 1345, 1345, "shared",
                            None),
    "f32_shared_b2_769": (torch.float32, 2, 16, 769, 769, "shared", None),
    # Boost on BEiT-L 512 (a bias shared across the batch): the whole
    # image at R_x 1536 on a 4:3 input (96 x 72 + 1) and a square one
    # (96^2 + 1), the patches at 1024^2 (64^2 + 1), the whole image at 512
    # on a 4:3 input (32 x 24 + 1)
    "bf16_shared_6913": (torch.bfloat16, 1, 16, 6913, 6913, "shared", None),
    "bf16_shared_9217": (torch.bfloat16, 1, 16, 9217, 9217, "shared", None),
    "bf16_shared_b4_4097": (torch.bfloat16, 4, 16, 4097, 4097, "shared",
                            None),
    "bf16_shared_769": (torch.bfloat16, 1, 16, 769, 769, "shared", None),
}
# Marigold's UNet at res 768 on a 4:3 input (latent 96 x 72, the ensemble
# of 5 on the batch), f32 (what its attention runs in, in its bf16 mode
# too: flax's promotion) and bf16 (the tensor-core body at those shapes):
# self-attention at the four levels and cross-attention on the empty
# prompt's 77 keys (13 in the last kv tile)
K1_CASES.update({
    f"{dn}_b5_h{h}_{n}_{kind}": (dt, 5, h, n, 77 if kind == "cross" else n,
                                 None, None)
    for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
    for kind in ("self", "cross")
    for h, n in ((5, 6912), (10, 1728), (20, 432), (20, 108))})
# DA v2 Base at net 448 in video mode's pass 1 (1080p frames, chunks of 8
# and a tail of 4: N = 1825) and the 3D photo's 4:3 image (N = 1377)
K1_CASES.update({
    "bf16_none_h12_b8_1825": (torch.bfloat16, 8, 12, 1825, 1825, None, None),
    "bf16_none_h12_b4_1825": (torch.bfloat16, 4, 12, 1825, 1825, None, None),
    "bf16_none_h12_1377": (torch.bfloat16, 1, 12, 1377, 1377, None, None)})


F32_ACCURACY = 5e-5


def _fault_errors(q, k, v, bias, scale, want):
    """The max abs error against ``want`` of the answer a kernel with each
    fault would give (the plain version on the same inputs): the last kv
    tile of 64 keys skipped (the ragged one where Nk % 64 != 0), the first
    one skipped, the output scaled by 0.8; for f32, one TF32 pass (q, k, v
    rounded to TF32)."""
    nk = k.shape[2]

    def without(keep):
        b = bias[..., keep] if bias is not None else None
        return fa.flash_attention_plain(q, k[:, :, keep], v[:, :, keep], b,
                                        scale)
    faults = {"x0.8": want.float() * 0.8}
    if nk > 64:
        faults["last_kv_tile"] = without(slice(0, nk - (nk % 64 or 64)))
        faults["first_kv_tile"] = without(slice(64, nk))
    if q.dtype == torch.float32:
        r = fa.round_to_tf32
        faults["tf32_one_pass"] = fa.flash_attention_plain(
            r(q), r(k), r(v), bias, scale)
    return {name: (f.float() - want.float()).abs().max().item()
            for name, f in faults.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_flash_attention_kernel_matches_plain(case):
    """Each bias in the padded-row layout the kernel reads (pad_bias_rows);
    bf16 runs the bf16 body, f32 the split-TF32 body, held to f32
    accuracy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(0)
    dt, b, h, n, nk, bias_kind, scale = K1_CASES[case]
    d = 64

    def mk(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to("cuda", dt)
    q, k, v = mk(b, h, n, d, s=4.0), mk(b, h, nk, d), mk(b, h, nk, d, s=0.25)
    bias = None
    if bias_kind:
        bias = fa.pad_bias_rows(
            mk(1 if bias_kind == "shared" else b, h, n, nk))
    if case.endswith("masked_row"):
        bias[:, :, 5] = float("-inf")
    got = fa.flash_attention_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias, scale)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-2 if dt == torch.bfloat16 else 5e-3
    assert err <= tol, err
    if dt == torch.float32:
        assert err <= F32_ACCURACY, err
    if case.endswith("masked_row"):
        assert torch.count_nonzero(got[:, :, 5]) == 0
    faults = _fault_errors(q, k, v, bias, scale, want)
    tf32 = faults.pop("tf32_one_pass", None)
    assert min(faults.values()) > tol, faults
    if dt == torch.float32:
        assert tf32 > F32_ACCURACY, tf32


def _chip_smoke():
    """chip_smoke.py as a module (its phase-2 helpers; main not run)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_flash_attention_bf16_rescale_does_not_drift():
    """N = 10765 (169 kv tiles), every row's max in the first tile, v
    rising with the key index (chip_smoke.py K1_ALPHA_*): the bf16
    kernel's signed mean error against f64 over all rows lies within
    K1_ALPHA_SIGMAS standard errors of 0, as the plain version's does;
    the old alpha form, restated, drifts outside."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sm = _chip_smoke()
    d = sm.k1_alpha_drift(fa)
    assert d["max_abs_err"] <= 2e-2
    for name in ("kernel", "plain", "difference"):
        mean, se = d[name]
        assert abs(mean) <= sm.K1_ALPHA_SIGMAS * se, (name, mean, se)
    mean, se = d["one_fma"]
    assert abs(mean) > sm.K1_ALPHA_SIGMAS * se, (mean, se)


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
# sharp).  over_32 and over_64 hold more than 32 and 64 live segments at
# a part (long windows; a replay there would outgrow a thread's list of 32
# and run its row whole); wide_sort sorts in device scratch
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


def _sweep_parts(img, nd, div, sharp):
    """How many sub-pixel parts the sweep steps through: a row's parts
    are its columns plus the sorted points inside [0, w)."""
    rows, w, _ = img.shape
    sorted_, _, _ = P._sort_cuda(img, nd, div, 0.0, 1.0, sharp)
    n_seg = 2 * w + 1 if sharp else w + 1
    pts = sorted_[0, :, :n_seg + 1].contiguous()
    edges = torch.tensor([0.0, float(w)], dtype=torch.float64,
                         device=pts.device).expand(rows, 2).contiguous()
    lo = torch.searchsorted(pts, edges)
    return int((lo[:, 1] - lo[:, 0]).sum()) + rows * w


@pytest.mark.cuda
def test_polylines_sweep_counts_its_replays():
    """The sweep's replay counter engages where exact ties of closeness
    leave the choice to the active list's order (the quantized ``ties``
    map, the synthetic tie segments) and reads 0 on the ``structured``
    map; every part is counted once, and no row of either map runs the
    host loop whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for case in ("ties", "structured"):
        rows, w, ch, kind, div, sep, expo, sharp = K2_CASES[case]
        rng = np.random.default_rng(3)
        img = torch.from_numpy(rng.integers(0, 256, (rows, w, ch),
                                            dtype=np.uint8)).cuda()
        nd = torch.from_numpy(_depth(kind, rows, w, 4)).cuda()
        P.reset_replay_counts()
        P.polylines_cuda(img, nd, div, sep, expo, sharp)
        counts = P.replay_counts()
        assert counts["parts"] == _sweep_parts(img, nd, div, sharp), case
        assert counts["rows_whole"] == 0, case
        if case == "ties":
            assert counts["parts_replayed"] > 0
        else:
            assert counts["parts_replayed"] == 0
    img, sorted_, rgb, order, _ = _synthetic_segments(
        np.random.default_rng(7), 3, 90, 3, True, 12.0)
    P.reset_replay_counts()
    P._sweep_cuda(torch.from_numpy(sorted_).cuda(),
                  torch.from_numpy(rgb).cuda(),
                  torch.from_numpy(order).cuda(), 90, 3, True)
    assert P.replay_counts()["parts_replayed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ["random", "smooth"])
def test_polylines_1080p_eyes_equal_the_host_kernel(depth):
    """Both sharp eyes of a 1080x1920 photo at the stereo cells'
    divergence (2.5% of the width, +-24 px an eye), byte-exact against
    the host kernel; no row runs the host loop whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(8)
    img = torch.randint(0, 256, (1080, 1920, 3), generator=g,
                        dtype=torch.uint8)
    if depth == "random":
        nd = torch.rand((1080, 1920), generator=g, dtype=torch.float64)
    else:
        yy, xx = torch.meshgrid(torch.arange(1080, dtype=torch.float64),
                                torch.arange(1920, dtype=torch.float64),
                                indexing="ij")
        nd = 0.5 + 0.5 * torch.sin(xx / 97.0) * torch.cos(yy / 61.0)
    for div in (24.0, -24.0):
        P.reset_replay_counts()
        got = P.polylines_cuda(img.cuda(), nd.cuda(), div, 0.0, 1.0,
                               True).cpu()
        assert P.replay_counts()["rows_whole"] == 0
        want = P.polylines_host(img, nd, div, 0.0, 1.0, True)
        assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["none", "naive", "naive_interpolating"])
@pytest.mark.parametrize("div,sep", [(1.25, 0.0), (-1.25, 0.0),
                                     (2.5, 0.4), (-2.5, -0.4)])
@pytest.mark.parametrize("exponent", [1.0, 1.7])
def test_warp_fills_card_equals_cpu(fill, div, sep, exponent):
    """One eye on the card, byte-equal to the CPU's, on a random and a
    smooth map and on one that holds every 16-bit level (the CPU's is
    byte-equal to the JAX package's: tests/test_torch_port_stereo.py).  At
    exponent 1.7 the card's f32 pow and the CPU's may differ in the last
    bit; no truncated offset moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, w = 128, 512
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.integers(0, 256, (rows, w, 3),
                                        dtype=np.uint8))
    depths = {kind: (_depth(kind, rows, w, 9) * 65535).astype(np.uint16)
              for kind in ("random", "structured")}
    depths["levels"] = rng.permutation(np.arange(65536, dtype=np.uint16)
                                       ).reshape(rows, w)
    for kind, d in depths.items():
        depth = torch.from_numpy(d)
        want = S.apply_stereo_divergence(img, depth, div, sep, exponent,
                                         fill)
        got = S.apply_stereo_divergence(img.cuda(), depth.cuda(), div, sep,
                                        exponent, fill)
        assert got.is_cuda
        assert torch.equal(got.cpu(), want), (kind, int((got.cpu()
                                                         != want).sum()))


@pytest.mark.cuda
def test_funnel_stereo_on_the_card_equals_the_host_route():
    """A chunk of two 1080p photos with polylines stereo through the funnel
    on the card (a small ViT DPT, f32): the photos sent again from the
    pinned staging, the maps kept on the card, the results down through
    pinned memory.  Each output equals create_stereoimages on the yielded
    numpy photo and map, and job 1's arrays are unchanged after job 2 ran
    on other photos (no yielded array views a reused buffer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline import core
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    from depthmap_tpu_torch.utils import profiling
    with torch.device("meta"):
        bundle = build_model(3)
    module = init_random_(_small_zoo_model("vit"), seed=2)
    pred = DepthPredictor(3, state_dict=module.state_dict(),
                          compute_dtype=torch.float32, device="cuda",
                          bundle=dataclasses.replace(bundle, module=module))

    class Cache(core.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return pred

    modes = ["left-right", "red-cyan-anaglyph"]
    opts = dict(compute_device="GPU", model_type=3, net_width=384,
                net_height=384, gen_stereo=True, stereo_modes=modes,
                stereo_fill_algo="polylines_sharp", stereo_divergence=2.5)
    rng = np.random.default_rng(11)
    jobs, outs, frozen = [], [], None
    for _ in range(2):
        imgs = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
                for _ in range(2)]
        profiling.reset()
        out = {(i, t): r for i, t, r in core.core_generation_funnel(
            None, imgs, None, None, opts, predictor_cache=Cache())}
        spans = profiling.timings()
        assert len(spans["stereo"]) == len(spans["stereo_on_card"]) == 2
        jobs.append(imgs)
        outs.append(out)
        if frozen is None:
            frozen = {k: v.copy() for k, v in out.items()}
    for k, v in frozen.items():
        assert np.array_equal(outs[0][k], v), k
    for imgs, out in zip(jobs, outs):
        for i, img in enumerate(imgs):
            want = S.create_stereoimages(img, out[(i, "depth")], 2.5, 0.0,
                                         modes, 0.0, 1.0, "polylines_sharp",
                                         device="cuda")
            for mode, w in zip(modes, want):
                assert out[(i, mode)].dtype == np.uint8
                assert np.array_equal(out[(i, mode)], w), (i, mode)


@pytest.mark.cuda
def test_small_depth_anything_card_matches_cpu():
    """A small Depth Anything v2 (embed 128, 2 heads of D = 64, depth 4,
    training size 56) through the predictor at net 70 (a 5 x 9 grid: the
    position embeddings are resized) in f32: K1 bias-free on the card, its
    plain version on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.depth_anything import DepthAnything
    from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor

    def small():
        return DepthAnything(DinoV2Backbone(embed_dim=128, depth=4,
                                            num_heads=2, hooks=(0, 1, 2, 3),
                                            train_img_size=56),
                             features=32, out_channels=(16, 32, 64, 64))

    sd = init_random_(small(), seed=2).state_dict()
    with torch.device("meta"):
        bundle = build_model(13)
    img = np.random.default_rng(3).random((2, 45, 77, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        pred = DepthPredictor(13, state_dict=sd, compute_dtype=torch.float32,
                              device=dev, bundle=dataclasses.replace(
                                  bundle, module=small()))
        before = fa.flash_attention_cuda.launches
        out[dev] = pred.predict_batch(img, 70, 70)
        out[dev + "_launches"] = fa.flash_attention_cuda.launches - before
    assert out["cuda_launches"] == 4 and out["cpu_launches"] == 0
    rng_ = float(np.ptp(out["cpu"]))
    assert rng_ > 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-3 * rng_)


def _small_zoo_model(kind: str) -> torch.nn.Module:
    """Small stand-ins of types 3-6: ViT and hybrid DPTs with embed 128 and
    2 heads of D = 64 (training grid 4), one-block ResNet / ResNeXt stages,
    EfficientNet-Lite3 with at most two blocks a stage."""
    import dataclasses
    from depthmap_tpu_torch.models import efficientnet, midas_net, vit
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    if kind == "vit":
        return DPTDepthModel(vit.VitBackbone(embed_dim=128, depth=4,
                                             num_heads=2, hooks=(0, 1, 2, 3),
                                             train_grid=4),
                             (16, 32, 64, 64), 32)
    if kind == "hybrid":
        return DPTDepthModel(vit.HybridVitBackbone(embed_dim=128, depth=4,
                                                   num_heads=2, hooks=(1, 3),
                                                   train_grid=4,
                                                   layers=(1, 1, 1)),
                             (256, 512, 64, 64), 32)
    if kind == "v21":
        return midas_net.build_midas_v21(layers=(1, 1, 1, 1), groups=8,
                                         width_per_group=4)
    return midas_net.build_midas_v21_small(cfgs=tuple(
        dataclasses.replace(c, repeats=min(c.repeats, 2))
        for c in efficientnet.LITE3))


def _small_metric_model(kind: str) -> torch.nn.Module:
    """Small stand-ins of types 0 and 7-9: LeReS on a one-block ResNeXt (8
    groups of width 4); ZoeDepth with 8 bins on a BEiT core of embed 128,
    2 heads of D = 64, depth 4, training size 64, in-model size 64 x 64."""
    from depthmap_tpu_torch.models import leres, zoedepth
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    if kind == "leres":
        return leres.build_leres(layers=(1, 1, 1, 1), groups=8,
                                 width_per_group=4)
    core = DPTDepthModel(BeitBackbone(embed_dim=128, depth=4, num_heads=2,
                                      hooks=(0, 1, 2, 3), train_img_size=64),
                         (16, 32, 64, 64), 32, with_zoe_taps=True)
    head = dict(n_bins=8, bin_embedding_dim=16)
    inner = zoedepth.ZoeDepthNK(core, **head) if kind == "zoe_nk" else \
        zoedepth.ZoeDepth(core, **head, **(
            dict(max_depth=80.0, bin_centers_type="normed")
            if kind == "zoe_k" else {}))
    return zoedepth.ZoeDepthInference(inner, (64, 64))


# kind -> (model type, K1 launches a forward on the card)
ZOO = {"vit": (3, 4), "hybrid": (4, 4), "v21": (5, 0), "small": (6, 0),
       "leres": (0, 0), "zoe_n": (7, 4), "zoe_k": (8, 4), "zoe_nk": (9, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ZOO))
def test_small_zoo_card_matches_cpu(kind):
    """Types 0 and 3-9 at a small size through the predictor in f32 (net
    100 on a 75 x 130 image: the ViTs' position embeddings and the BEiT
    core's bias table are resized; LeReS squashes to 96, a multiple of its
    stride 32), card against CPU; K1 runs every ViT
    block on the card (ZoeDepth's once for the flip-TTA batch), never on
    the CPU, and never in a conv net."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    mt, launches = ZOO[kind]
    small = _small_zoo_model if mt in (3, 4, 5, 6) else _small_metric_model
    sd = init_random_(small(kind), seed=2).state_dict()
    with torch.device("meta"):
        bundle = build_model(mt)
    img = np.random.default_rng(3).random((2, 75, 130, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        pred = DepthPredictor(mt, state_dict=sd, compute_dtype=torch.float32,
                              device=dev, bundle=dataclasses.replace(
                                  bundle, module=small(kind)))
        before = fa.flash_attention_cuda.launches
        net = 96 if kind == "leres" else 100
        out[dev] = pred.predict_batch(img, net, net)
        out[dev + "_launches"] = fa.flash_attention_cuda.launches - before
    assert (out["cuda_launches"], out["cpu_launches"]) == (launches, 0)
    rng_ = float(np.ptp(out["cpu"]))
    assert rng_ > 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-3 * rng_)


@pytest.mark.cuda
@pytest.mark.parametrize("pre_blur", [None, 3, 5])
@pytest.mark.parametrize("sobel_k", [None, 1, 3, 5])
def test_normalmap_card_matches_cpu(pre_blur, sobel_k):
    """The normal map on the card against the CPU's, on a random and a
    smooth 16-bit map, with and without post-blur and invert: |d| <= 1 on
    <= 0.1% of the bytes (the CPU's is held to the JAX package's in
    tests/test_torch_port_outputs.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from depthmap_tpu_torch.ops.normalmap import create_normalmap
    rows, w = 120, 200
    maps = {kind: (_depth(kind, rows, w, 10) * 65535).astype(np.uint16)
            for kind in ("random", "structured")}
    for kind, d in maps.items():
        for post_blur in (None, 3):
            for invert in (False, True):
                args = (pre_blur, sobel_k, post_blur, invert)
                got = create_normalmap(
                    torch.from_numpy(d.astype(np.float32)).cuda(), *args)
                assert got.is_cuda and got.dtype == torch.uint8
                want = create_normalmap(d, *args)
                diff = (got.cpu().int() - want.int()).abs()
                assert int(diff.max()) <= 1, (kind, args)
                assert float((diff > 0).float().mean()) <= 1e-3, (kind, args)


@pytest.mark.cuda
def test_small_marigold_card_matches_cpu():
    """Marigold's pipeline on small nets with heads of D = 64 (UNet base
    64: 1, 2 and 4 heads; VAE base 32), 48 x 64 members, 2 steps, the same
    noise, f32: K1 runs the 16 self- and 16 cross-attentions of each UNet
    forward on the card (the 77 keys of the empty prompt), all in its f32
    body, none on the CPU; the members hold to 1e-3 of the CPU's range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from depthmap_tpu_torch.models.marigold.pipeline import build_marigold
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline.depth import set_fp32_precision
    set_fp32_precision(torch.device("cuda"))
    sd = init_random_(build_marigold(base=64, vae_base=32, context_dim=64),
                      seed=2).state_dict()
    img = np.random.default_rng(4).random((48, 64, 3)).astype(np.float32)
    rgb = torch.from_numpy(img).permute(2, 0, 1)[None].expand(2, -1, -1, -1)
    noise = torch.randn((2, 4, 6, 8), generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = build_marigold(base=64, vae_base=32, context_dim=64)
        pipe.load_state_dict(sd)
        pipe = pipe.to(dev).eval()
        before = fa.flash_attention_cuda.launches
        before_f32 = fa.flash_attention_cuda.launches_by_dtype["float32"]
        out[dev] = pipe.single_infer(rgb.to(dev), 2, noise).cpu().numpy()
        out[dev + "_launches"] = fa.flash_attention_cuda.launches - before
        out[dev + "_f32"] = (fa.flash_attention_cuda.launches_by_dtype[
            "float32"] - before_f32)
    assert (out["cuda_launches"], out["cpu_launches"]) == (64, 0)
    assert (out["cuda_f32"], out["cpu_f32"]) == (64, 0)  # the f32 body
    rng_ = float(np.ptp(out["cpu"]))
    assert rng_ > 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-3 * rng_)


# -- the 3D photo: plain torch on the card, held to the CPU --

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [7, 5])
def test_weighted_median_card_equals_cpu(window):
    _needs_card()
    from depthmap_tpu_torch.pipeline import inpaint_mesh as im
    rng = np.random.default_rng(window)
    depth = np.round(1.0 / np.maximum(rng.random((96, 128)) * 3, 0.05), 1)
    depth[20:60, 30:90] *= 3
    depth = depth.astype(np.float32)
    disc = im.vis_depth_discontinuity(depth, 0.04)
    out = {dev: im.weighted_median_filter(
        torch.from_numpy(depth).to(dev), torch.from_numpy(disc).to(dev),
        window).cpu().numpy() for dev in ("cuda", "cpu")}
    assert (out["cpu"] != depth).sum() > 100
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


@pytest.fixture(scope="module")
def inpaint_ckpt(tmp_path_factory):
    from depthmap_tpu_torch.models.weights import \
        save_random_inpaint_checkpoints
    d = str(tmp_path_factory.mktemp("3dphoto"))
    save_random_inpaint_checkpoints(d, seed=7)
    return d


@pytest.mark.cuda
def test_inpaint_nets_card_match_cpu(inpaint_ckpt):
    """The three full-width nets on a 128 x 128 crop, f32 with TF32 off:
    within 1e-4 of the CPU output's range."""
    _needs_card()
    from depthmap_tpu_torch.pipeline import inpaint_mesh as im
    rng = np.random.default_rng(8)
    rgb = rng.random((128, 128, 3)).astype(np.float32)
    depth = (3 + 5 * rng.random((128, 128))).astype(np.float32)
    edge = (rng.random((128, 128)) > 0.9).astype(np.float32)
    ctx = (rng.random((128, 128)) > 0.4).astype(np.float32)
    mask = (1 - ctx) * (rng.random((128, 128)) > 0.3).astype(np.float32)
    args = {"edge": (rgb, 1 / depth, edge, ctx, mask),
            "depth": (depth, edge, ctx, mask),
            "color": (rgb, edge, ctx, mask)}
    nets = {dev: im.build_inpaint_callables(inpaint_ckpt, device=dev)
            for dev in ("cuda", "cpu")}
    before = dict(im.net_calls)
    for name, a in args.items():
        want = nets["cpu"][name](*a)
        got = nets["cuda"][name](*a)
        span = float(np.ptp(want))
        assert span > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * span)
    assert all(im.net_calls[(n, "cuda")] - before.get((n, "cuda"), 0)
               == 1 for n in args)


@pytest.mark.cuda
def test_raster_card_equals_cpu(inpaint_ckpt):
    """The renderer on tests/test_render.py's nested-occlusion scene (its
    LDI with the nets), 3 cameras, triangles and splat: equal frames (each
    op is one IEEE f32 operation, the winner rule is order-free)."""
    _needs_card()
    from depthmap_tpu_torch.pipeline import inpaint_mesh as im
    from depthmap_tpu_torch.pipeline.render import MeshRenderer
    H, W = 48, 64
    rng = np.random.default_rng(0)
    depth = np.full((H, W), 10.0)
    depth[12:36, 16:48] = 5.0
    depth[18:30, 24:40] = 2.0
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    int_mtx = np.array([[max(H, W), 0, W / 2.], [0, max(H, W), H / 2.],
                        [0, 0, 1]])
    nets = im.build_inpaint_callables(inpaint_ckpt, device="cpu")
    verts, colors, faces, _ = im.build_ldi(
        img, depth, int_mtx, {"depth_threshold": 0.04,
                              "background_thickness": 70}, nets)
    fov = max(2 * np.arctan(0.5 * W / (int_mtx[0, 0] * W)),
              2 * np.arctan(0.5 * H / (int_mtx[1, 1] * H)))
    for method in ("triangles", "splat"):
        for cam in ((0.0, 0.0, 0.0), (0.02, -0.015, -0.03),
                    (-0.03, 0.02, 0.05)):
            frames = {dev: MeshRenderer(verts, colors, faces, fov, 64,
                                        method=method, device=dev)
                      .render_device(np.asarray(cam)).cpu().numpy()
                      for dev in ("cuda", "cpu")}
            np.testing.assert_array_equal(frames["cuda"], frames["cpu"])


# -- K1's gradient and the splits over a repeated card ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", ["shared", "batched", None])
def test_flash_attention_gradient_matches_plain(bias_kind):
    """With inputs that require grad, K1's output carries a graph
    (FlashAttentionFunction: K1's forward, the backward in torch) whose
    dq, dk, dv and dbias match autograd through the plain version in f64
    within K1_GRAD_BOUND, f32 body: the plain version's function
    (softmax(q.k^T / 8 + bias).v) by autograd in f64; a padded-row bias's
    gradient reaches the dense tensor it was copied from."""
    _needs_card()
    g = torch.Generator(device="cpu").manual_seed(3)
    b, h, n = 2, 4, 257

    def mk(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).cuda()
    q, k, v = mk(b, h, n, 64, s=4.0), mk(b, h, n, 64), mk(b, h, n, 64,
                                                           s=0.25)
    dense = None if bias_kind is None else mk(
        1 if bias_kind == "shared" else b, h, n, n)
    dout = mk(b, h, n, 64)
    ins = [t.requires_grad_() for t in (q, k, v)] + (
        [dense.requires_grad_()] if dense is not None else [])
    before = fa.flash_attention_cuda.launches
    out = fa.flash_attention(q, k, v, None if dense is None
                             else fa.pad_bias_rows(dense))
    assert fa.flash_attention_cuda.launches == before + 1
    assert out.requires_grad and out.grad_fn is not None
    got = torch.autograd.grad((out * dout).sum(), ins)
    ref = [t.detach().double().requires_grad_() for t in ins]
    s = ref[0] @ ref[1].transpose(-1, -2) * 64 ** -0.5
    if dense is not None:
        s = s + ref[3]
    want = torch.autograd.grad(
        ((torch.softmax(s, -1) @ ref[2]) * dout.double()).sum(), ref)
    for name, a, w in zip("qkvb", got, want):
        err = (a.double() - w).abs().max().item()
        assert err <= K1_GRAD_BOUND * w.abs().max().item(), (name, err)


# dq, dk, dv, dbias from K1's f32 body against the function's in f64:
# the forward errs ~1e-6 of its outputs (split TF32) and the backward is
# f32 torch; 1e-4 of each gradient's largest magnitude holds both with
# room, and a detached output (no gradient at all) fails it
K1_GRAD_BOUND = 1e-4


@pytest.mark.cuda
def test_polylines_row_split_over_a_repeated_card(monkeypatch):
    """K2's rows padded and split over two visible cards, the one card
    twice ([cuda:0, cuda:0]): one sort and one sweep per shard,
    byte-equal to one launch."""
    _needs_card()
    from depthmap_tpu_torch.parallel import mesh
    g = torch.Generator(device="cpu").manual_seed(4)
    img = torch.randint(0, 256, (67, 480, 3), generator=g,
                        dtype=torch.uint8).cuda()
    nd = torch.rand((67, 480), generator=g).cuda()
    one = P.polylines_rasterize(img, nd, 24.0, 0.0, 1.0, True, shard=False)
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device="cuda": [torch.device("cuda", 0)] * 2)
    sorts, sweeps = P._sort_cuda.launches, P._sweep_cuda.launches
    split = P.polylines_rasterize(img, nd, 24.0, 0.0, 1.0, True)
    torch.cuda.synchronize()
    assert (P._sort_cuda.launches - sorts, P._sweep_cuda.launches - sweeps) \
        == (2, 2)
    assert torch.equal(split, one)


@pytest.mark.cuda
def test_splits_over_the_card_and_the_cpu_copy_the_modules(monkeypatch):
    """A device list of [cuda:0, cpu] makes real copies of the modules on
    the CPU (one card repeated shares its module): predict_batch of a
    small Depth Anything v2 (f32), Boost on it (a 6-level merge net at
    PIX2PIX_SIZE 64, receptive field 64) and a small Marigold's members
    each hold to the unsplit run on the card within 1e-3 of its range
    (K1 on the card's shard, its plain version on the CPU's: the card
    against CPU bound of the tests above); the card's shard launches K1,
    the CPU's none; a copy follows a load of new weights."""
    _needs_card()
    import dataclasses
    from depthmap_tpu_torch.models import pix2pix
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.depth_anything import DepthAnything
    from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone
    from depthmap_tpu_torch.models.marigold.pipeline import build_marigold
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.parallel.mesh import replica
    from depthmap_tpu_torch.pipeline import boost as B
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    mixed = [cuda, cpu]

    def close(got, want):
        span = float(np.ptp(want))
        assert span > 0 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * span)

    small = DepthAnything(DinoV2Backbone(embed_dim=128, depth=4, num_heads=2,
                                         hooks=(0, 1, 2, 3),
                                         train_img_size=56),
                          features=32, out_channels=(16, 32, 64, 64))
    sd = init_random_(small, seed=7).state_dict()
    with torch.device("meta"):
        bundle = build_model(13)
    preds = {}
    for name, devices in (("split", mixed), ("one", [cuda])):
        preds[name] = DepthPredictor(
            13, state_dict=sd, compute_dtype=torch.float32, device="cuda",
            devices=devices, bundle=dataclasses.replace(bundle,
                                                        module=small))
    frames = np.random.default_rng(8).random((2, 45, 77, 3)).astype(
        np.float32)
    before = fa.flash_attention_cuda.launches
    got = preds["split"].predict_batch(frames, 70, 70)
    assert fa.flash_attention_cuda.launches - before == 4   # one frame
    copy = preds["split"].module_on(cpu)
    assert copy is not small and next(copy.parameters()).device == cpu
    close(got, preds["one"].predict_batch(frames, 70, 70))

    monkeypatch.setattr(B, "PIX2PIX_SIZE", 64)
    merge = init_random_(pix2pix.Pix2Pix4Depth(num_downs=6, ngf=8), 9)
    img = np.random.default_rng(9).random((96, 128, 3)).astype(np.float32)
    maps = {}
    for name, pred in preds.items():
        engine = B.BoostEngine(pred, merge_net=merge, merge_batch=2)
        engine.rf = 64
        maps[name] = engine.estimate(img, whole_size_threshold=256)
        maps[name + "_run"] = dict(engine.last_run)
    assert maps["split_run"]["patches"] > 0
    assert replica(merge, cpu) is not merge
    close(maps["split"], maps["one"])

    pipe = build_marigold(base=64, vae_base=32, context_dim=64)
    init_random_(pipe, seed=2)
    pipe = pipe.cuda().eval()
    rgb = np.random.default_rng(4).random((48, 64, 3)).astype(np.float32)
    noise = torch.randn((2, 4, 6, 8),
                        generator=torch.Generator().manual_seed(5))
    run = dict(rgb01=rgb, processing_res=64, ensemble_size=2,
               denoising_steps=2, noise=noise)
    before = fa.flash_attention_cuda.launches
    members = pipe.members(devices=mixed, **run)
    assert fa.flash_attention_cuda.launches - before == 64  # one member
    close(members, pipe.members(**run))
    first = replica(pipe, cpu)
    pipe.load_state_dict(init_random_(build_marigold(
        base=64, vae_base=32, context_dim=64), seed=3).state_dict())
    assert replica(pipe, cpu) is not first
    close(pipe.members(devices=mixed, **run), pipe.members(**run))


# -- K1's table mode: BEiT's streamed rel-pos bias -------------------------

# case: (dtype, B, H, (gh, gw)).  4:3 and square grids in both bodies;
# Boost's whole image at R_x 1024 on a 4:3 input (48 x 64); a grid whose
# N (36) is less than one tile, at 4 heads
REL_CASES = {
    "bf16_43": (torch.bfloat16, 2, 16, (12, 16)),
    "bf16_square": (torch.bfloat16, 1, 16, (16, 16)),
    "f32_43": (torch.float32, 2, 16, (12, 16)),
    "f32_square": (torch.float32, 1, 16, (16, 16)),
    "bf16_boost_43": (torch.bfloat16, 1, 16, (48, 64)),
    "f32_short": (torch.float32, 1, 4, (5, 7)),
    # the staged window: a thin grid whose tiles span many grid rows, a
    # tall one, and the widest grid the stage's slot takes (two grid rows,
    # so windows cross a row), each in both bodies; 16 heads there, so
    # the planted cls fault shows (with one head at N = 3893 it moved the
    # bf16 outputs by 2e-3: a row's cls -> token entries shift all its
    # logits alike, and key 0 rarely carries weight)
    **{f"{dn}_{kind}": (dt, b, h, grid)
       for dn, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
       for kind, b, h, grid in (
           ("thin", 1, 4, (3, 200)), ("tall", 1, 4, (200, 3)),
           ("window_limit", 1, 16, (2, fa.rel_window_max_gw(dt))))},
}


def _rel_inputs(dt, b, h, grid, seed=4):
    """q x4, k, v x1/4 and a (num_rel + 3, H) table ~ 3 N(0, 1) (a spread
    of a few units, so a wrong index shows), on the card in ``dt``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    gh, gw = grid
    n = gh * gw + 1
    t = (2 * gh - 1) * (2 * gw - 1) + 3

    def mk(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to("cuda", dt)
    return (mk(b, h, n, 64, s=4.0), mk(b, h, n, 64), mk(b, h, n, 64, s=0.25),
            mk(t, h, s=3.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REL_CASES))
def test_flash_attention_table_mode(case):
    """Table mode is byte-equal to K1 with the bias materialized from the
    same table (rel_pos_bias, the padded-row layout), within the K1 bound
    of the plain streamed version on the card, and counted as a "rel"
    launch; the answers of two planted faults, gh and gw swapped (4:3
    grids) and the two cls entries swapped, break the bound."""
    from depthmap_tpu_torch.models import attention as A
    from depthmap_tpu_torch.models.beit import rel_pos_bias
    _needs_card()
    dt, b, h, grid = REL_CASES[case]
    q, k, v, table = _rel_inputs(dt, b, h, grid)
    before = dict(fa.flash_attention_cuda.launches_by_mode)
    got = fa.flash_attention_rel(q, k, v, fa.pad_table_rows(table), grid)
    torch.cuda.synchronize()
    after = fa.flash_attention_cuda.launches_by_mode
    assert after["rel"] == before["rel"] + 1
    assert after["bias"] == before["bias"]
    materialized = fa.flash_attention_cuda(
        q, k, v, rel_pos_bias(table, grid, grid))
    assert torch.equal(got, materialized)
    want = A.attention_rel_streamed(q, k, v, A.RelBiasSpec(table, *grid))
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-2 if dt == torch.bfloat16 else F32_ACCURACY
    assert err <= tol, err
    num_rel = table.shape[0] - 3
    swapped = table.clone()
    swapped[[num_rel, num_rel + 1]] = table[[num_rel + 1, num_rel]]
    faults = {"cls_swapped": A.attention_rel_streamed(
        q, k, v, A.RelBiasSpec(swapped, *grid))}
    if grid[0] != grid[1]:
        faults["grid_swapped"] = A.attention_rel_streamed(
            q, k, v, A.RelBiasSpec(table, grid[1], grid[0]))
    for name, f in faults.items():
        assert (f.float() - want.float()).abs().max().item() > tol, name


@pytest.mark.cuda
def test_flash_attention_table_mode_refuses_what_it_does_not_take():
    """A table in another dtype than f32, a grid that does not give N and a
    table whose rows are not padded to 16 bytes raise; nothing
    launches."""
    _needs_card()
    q, k, v, table = _rel_inputs(torch.bfloat16, 1, 16, (3, 4))
    before = fa.flash_attention_cuda.launches
    with pytest.raises(TypeError):   # the table must be f32
        fa.flash_attention_rel(q, k, v,
                               fa.pad_table_rows(table).to(torch.bfloat16),
                               (3, 4))
    with pytest.raises(ValueError):
        fa.flash_attention_rel(q, k, v, fa.pad_table_rows(table), (4, 4))
    with pytest.raises(ValueError, match="16 bytes"):   # T = 38: unpadded
        fa.flash_attention_rel(q, k, v, table.t().float().contiguous(),
                               (3, 4))
    assert fa.flash_attention_cuda.launches == before


@pytest.mark.cuda
def test_small_beit_streamed_gradient_matches_hoisted(monkeypatch):
    """A small BEiT backbone (2 blocks, 128 wide, 2 heads of 64) in f32 on
    the card under grad: with DEPTHMAP_BIAS_STREAM_BYTES=0 its blocks
    stream (the chunked gather into K1, the table's gradient through the
    gather), and the loss and every parameter's gradient, the tables'
    included, match the run with the biases built up front and passed in
    (rel_bias, built under grad); without grad the streamed forward runs
    K1's table mode, one launch a block."""
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.weights import init_random_
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    bb = init_random_(BeitBackbone(embed_dim=128, depth=2, num_heads=2,
                                   hooks=(0, 1), train_img_size=64), 5)
    bb = bb.cuda()
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 3, 64, 96)).astype(np.float32)).cuda()
    grid = (4, 6)

    def run(rel_bias=None):
        bb.zero_grad()
        feats, _ = bb(x, rel_bias=rel_bias)
        loss = sum((f * f).mean() for f in feats)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in bb.named_parameters()}
    hoisted = run(tuple(bb.block_bias(i, grid) for i in range(2)))
    monkeypatch.setenv("DEPTHMAP_BIAS_STREAM_BYTES", "0")
    streamed = run()
    assert streamed[0] == pytest.approx(hoisted[0], rel=1e-6)
    for name, g in hoisted[1].items():
        err = (streamed[1][name] - g).abs().max().item()
        assert err <= 1e-5 * max(g.abs().max().item(), 1e-12), name
    assert hoisted[1]["model.blocks.0.attn.relative_position_bias_table"] \
        .abs().max() > 0
    before = fa.flash_attention_cuda.launches_by_mode["rel"]
    with torch.no_grad():
        bb(x)
    assert fa.flash_attention_cuda.launches_by_mode["rel"] == before + 2
