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
q is drawn 4x and v 1/4x N(0, 1): the logits have std 4, so the softmax
is peaked and the outputs (up to ~1.4) stand far above the bound where a
kernel errs; each case also checks that the answers of planted faults (a
kv tile skipped, the output scaled by 0.8) break the bound.
K2 and the warp stereo fills are byte-exact.  Small Depth Anything, ViT
and hybrid DPT forwards in f32 on the card (K1 bias-free, TF32 off), and
the conv nets midas_v21 / midas_v21_small (no K1), hold to 1e-3 of the CPU
map's range, the bound chip_smoke.py holds the whole path to.  The normal
map on the card holds to its CPU twin within |d| <= 1 on <= 0.1% of the
bytes.
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
# BEiT-384 N = 577 with a bias (rows padded to 592).
K1_CASES = {
    "bf16_shared_1025": (torch.bfloat16, 4, 16, 1025, 1025, "shared", None),
    "bf16_shared_1793": (torch.bfloat16, 1, 16, 1793, 1793, "shared", None),
    "bf16_batched_65": (torch.bfloat16, 2, 16, 65, 65, "batched", None),
    "bf16_shared_n1": (torch.bfloat16, 2, 16, 1, 1, "shared", None),
    "bf16_none_cross": (torch.bfloat16, 1, 16, 77, 300, None, None),
    "bf16_masked_row": (torch.bfloat16, 2, 16, 130, 130, "shared", None),
    "bf16_scale": (torch.bfloat16, 2, 16, 200, 200, "batched", 0.3),
    "f32_batched_130": (torch.float32, 2, 16, 130, 130, "batched", None),
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
}


def _fault_errors(q, k, v, bias, scale, want):
    """The max abs error against ``want`` of the answer a kernel with each
    fault would give (the plain version on the same inputs): the last kv
    tile of 64 keys skipped (the ragged one where Nk % 64 != 0), the first
    one skipped, the output scaled by 0.8."""
    nk = k.shape[2]

    def without(keep):
        b = bias[..., keep] if bias is not None else None
        return fa.flash_attention_plain(q, k[:, :, keep], v[:, :, keep], b,
                                        scale)
    faults = {"x0.8": want.float() * 0.8}
    if nk > 64:
        faults["last_kv_tile"] = without(slice(0, nk - (nk % 64 or 64)))
        faults["first_kv_tile"] = without(slice(64, nk))
    return {name: (f.float() - want.float()).abs().max().item()
            for name, f in faults.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_flash_attention_kernel_matches_plain(case):
    """Each bias in the padded-row layout the kernel reads (pad_bias_rows);
    bf16 runs the tensor-core body, f32 the CUDA-core body."""
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
    if case == "bf16_masked_row":
        bias[:, :, 5] = float("-inf")
    got = fa.flash_attention_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias, scale)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-2 if dt == torch.bfloat16 else 5e-3
    assert err <= tol, err
    if case == "bf16_masked_row":
        assert torch.count_nonzero(got[:, :, 5]) == 0
    faults = _fault_errors(q, k, v, bias, scale, want)
    assert min(faults.values()) > tol, faults


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


# kind -> (model type, K1 launches a forward on the card)
ZOO = {"vit": (3, 4), "hybrid": (4, 4), "v21": (5, 0), "small": (6, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ZOO))
def test_small_zoo_card_matches_cpu(kind):
    """Types 3-6 at a small size through the predictor in f32 (net 100 on a
    75 x 130 image: the ViTs' position embeddings are resized), card
    against CPU; K1 runs every ViT block on the card, never on the CPU,
    and never in a conv net."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    mt, launches = ZOO[kind]
    sd = init_random_(_small_zoo_model(kind), seed=2).state_dict()
    with torch.device("meta"):
        bundle = build_model(mt)
    img = np.random.default_rng(3).random((2, 75, 130, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        pred = DepthPredictor(mt, state_dict=sd, compute_dtype=torch.float32,
                              device=dev, bundle=dataclasses.replace(
                                  bundle, module=_small_zoo_model(kind)))
        before = fa.flash_attention_cuda.launches
        out[dev] = pred.predict_batch(img, 100, 100)
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
