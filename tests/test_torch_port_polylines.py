"""Kernel K2 (depthmap_tpu_torch/ops/polylines.py) and create_stereoimages.

On the CPU: the port's host kernel (csrc/polylines_host.cpp, what CPU
tensors run) and the plain version are byte-exact against the reference
oracle (tests/oracles.py stereo_polylines) and the JAX package's host C++
kernel (depthmap_tpu.ops.polylines.apply_stereo_divergence_polylines), on
the cases of tests/test_polylines_pallas.py; create_stereoimages is
byte-exact against the JAX function for all 8 modes and several balances.
The CUDA kernel against the plain version is in
tests/test_torch_port_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from depthmap_tpu.ops.polylines import apply_stereo_divergence_polylines
from depthmap_tpu.ops.stereo import create_stereoimages as j_create
from depthmap_tpu_torch.ops import polylines as P
from depthmap_tpu_torch.ops.stereo import STEREO_MODES, create_stereoimages
from tests.oracles import stereo_polylines


def _check(img, nd, divpx, sep, expo, sharp):
    """polylines_rasterize (the host kernel on CPU tensors) and
    polylines_plain, each byte-equal to the oracle and the JAX host
    kernel."""
    fill = "polylines_sharp" if sharp else "polylines_soft"
    nd64 = nd.astype(np.float64)
    launches = P.polylines_host.launches
    got = P.polylines_rasterize(torch.from_numpy(img), torch.from_numpy(nd),
                                divpx, sep, expo, sharp).numpy()
    assert P.polylines_host.launches == launches + 1
    plain = P.polylines_plain(torch.from_numpy(img), torch.from_numpy(nd64),
                              divpx, sep, expo, sharp).numpy()
    for out in (got, plain):
        np.testing.assert_array_equal(
            out, stereo_polylines(img, nd64, divpx, sep, expo, fill))
        np.testing.assert_array_equal(
            out, apply_stereo_divergence_polylines(img, nd64, divpx, sep,
                                                   expo, fill))
    return got


def test_compact_matches_swap_with_last(rng):
    """The closed-form removal equals the host kernel's loop."""
    for _ in range(200):
        n = int(rng.integers(0, 12))
        cap = 14
        vals = rng.permutation(50)[:n]
        alive = rng.random(n) < 0.5
        ref = list(vals)
        flags = dict(zip(vals.tolist(), alive.tolist()))
        i = 0
        while i < len(ref):
            if not flags[ref[i]]:
                ref[i] = ref[-1]
                ref.pop()
            else:
                i += 1
        act = torch.zeros((1, cap), dtype=torch.int64)
        act[0, :n] = torch.from_numpy(vals)
        al = torch.zeros((1, cap), dtype=torch.bool)
        al[0, :n] = torch.from_numpy(alive)
        out, m = P._compact(act, al)
        assert int(m[0]) == len(ref)
        assert out[0, :len(ref)].tolist() == ref


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div", [2.5, -2.5])
def test_random_depth(rng, sharp, div):
    h, w = 16, 96
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    nd = rng.random((h, w)).astype(np.float32)
    _check(img, nd, div / 100 * w, 0.0, 1.0, sharp)


def test_separation_and_exponent(rng):
    h, w = 8, 96
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    nd = rng.random((h, w)).astype(np.float32)
    _check(img, nd, 2.0, 1.5, 2.0, True)
    _check(img, nd, -2.0, -1.5, 2.0, False)


def test_structured_and_flat_depth(rng):
    h, w = 12, 96
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    nd = (0.5 + 0.5 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.float32)
    _check(img, nd, 2.3, 0.0, 1.0, True)
    # constant depth: every part ties in closeness, which stresses the
    # active-list order of the tie-break
    flat = np.full((h, w), 0.5, np.float32)
    _check(img, flat, 2.3, 0.0, 1.0, True)
    _check(img, flat, -4.1, 0.0, 1.0, False)


def test_large_divergence_f64_depth(rng):
    """5% divergence, f64 depth, soft and sharp."""
    h, w = 6, 80
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    nd = rng.random((h, w))
    for sharp in (True, False):
        _check(img, nd, 0.05 * w, 0.0, 1.0, sharp)
        _check(img, nd, -0.05 * w, 0.7, 0.5, sharp)


def _max_active(nd, w, divpx, sep, expo, sharp):
    """Most segments on the host kernel's active list over all parts of
    all rows (its push and swap-with-last removal only)."""
    most = 0
    for row in np.asarray(nd, np.float64):
        cx = np.arange(w) + 0.5 + row ** expo * divpx + sep
        x = np.stack([cx - 0.45, cx + 0.45], 1).ravel() if sharp else cx
        px = np.concatenate([[-1.0 * w], x, [2.0 * w]])
        order = np.argsort(px[:-1], kind="stable")
        pts = np.concatenate([px[order], px[-1:]])
        x1 = px[order + 1]
        active, ptr, j = [], 0, 0
        for col in range(w):
            while pts[j + 1] < col:
                j += 1
            while True:
                a, b = pts[j], pts[j + 1]
                cf = max(float(col), a) + 1e-7
                xc = cf + 0.5 * (min(col + 1.0, b) - 1e-7 - cf)
                while ptr < len(order) and pts[ptr] < xc:
                    active.append(ptr)
                    ptr += 1
                active = [s for s in active if not x1[s] < xc]
                most = max(most, len(active))
                if not b < col + 1:
                    break
                j += 1
    return most


@pytest.mark.parametrize("case", ["random_sharp", "random_soft",
                                  "steps_sharp", "steps_soft", "flat_wide"])
def test_many_active_segments(rng, case):
    """The regimes the card's sweep must meet: more than 32 active
    segments (random depth, +-200 px at w = 256) and depth steps or flat
    depth at divergences where segments overlap."""
    h, w = 3, 256
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    sharp = case.endswith("sharp")
    if case.startswith("random"):
        nd, divpx = rng.random((h, w)), 200.0 if sharp else -200.0
    elif case.startswith("steps"):
        nd = np.tile((np.arange(w) // 16 % 2).astype(np.float64), (h, 1))
        divpx = 60.0 if sharp else -60.0
    else:
        nd, divpx = np.full((h, w), 0.75), -120.0
    _check(img, nd, divpx, 0.0, 1.0, sharp)
    if case.startswith("random"):
        assert _max_active(nd, w, divpx, 0.0, 1.0, sharp) > 32
    if case.startswith("steps"):
        assert _max_active(nd, w, divpx, 0.0, 1.0, sharp) > 2


def _sorted_segments(nd, w, divpx, sharp):
    """polylines_plain's sorted segments, row by row: its points
    (``_points``) stably sorted by x, as (pts with the last point, x1, d0,
    d1) f64 arrays."""
    px, pd, _ = P._points(torch.from_numpy(nd), w, divpx, 0.0, 1.0, sharp)
    n_seg = px.shape[1] - 1
    sx0, order = torch.sort(px[:, :n_seg], dim=1, stable=True)
    pts = torch.cat([sx0, px[:, n_seg:]], 1)
    return [t.numpy() for t in (pts, px.gather(1, order + 1),
                                pd.gather(1, order), pd.gather(1, order + 1))]


def _parts(pts, w):
    """The host loop's sub-pixel parts of a row in step order: (column,
    start point, centre xc)."""
    parts, j = [], 0
    for col in range(w):
        while pts[j + 1] < col:
            j += 1
        while True:
            a, b = pts[j], pts[j + 1]
            cf = (a if col < a else float(col)) + P.EPS
            ct = (b if b < col + 1.0 else col + 1.0) - P.EPS
            parts.append((col, j, cf + 0.5 * (ct - cf)))
            if not b < col + 1:
                break
            j += 1
    return parts


def _list_choice(active, xc, x0, x1, d0, d1):
    """The host loop's choice on its active list."""
    best = active[0] if active else -1
    if len(active) != 1:
        top = -P.EPS
        for s in active:
            ip = (xc - x0[s]) / (x1[s] - x0[s])
            cl = (1.0 - ip) * d0[s] + ip * d1[s]
            if top < cl and 0.0 < ip < 1.0:
                top, best = cl, s
    return best


def _steps(active, ptr, xcs, x0, x1):
    """The host loop's pushes and swap-with-last removals over the parts
    with centres xcs, on segment indices; returns the list and pointer."""
    active = list(active)
    for xc in xcs:
        while ptr < len(x1) and x0[ptr] < xc:
            active.append(ptr)
            ptr += 1
        i = 0
        while i < len(active):
            if x1[active[i]] < xc:
                active[i] = active[-1]
                active.pop()
            else:
                i += 1
    return active, ptr


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties", "beyond"])
def test_sweep_window_rule_matches_the_list_order(rng, kind, sharp):
    """The rule of K2's sweep (csrc/polylines.cu polylines_sweep): part
    centres never fall along a row, so after a part's pushes and removals
    the active set is the window {x0 < xc <= x1}, found below the push
    pointer down to where the running maximum of the ends falls below xc.
    Where one candidate holds the greatest closeness, or at most one
    segment is live, the window's choice is the list's; elsewhere a replay
    of the host loop's steps from the nearest earlier part with at most
    one live segment rebuilds the list in its order."""
    rows, w = 4, 96
    nd = {"random": rng.random((rows, w)),
          "ties": rng.integers(0, 5, (rows, w)) / 4.0,
          "beyond": rng.random((rows, w)) * 90.0}[kind]
    divpx = 1.0 if kind == "beyond" else (8.0 if sharp else -8.0)
    replays = 0
    for pts, x1, d0, d1 in zip(*_sorted_segments(nd, w, divpx, sharp)):
        x0 = pts[:-1]
        parts = _parts(pts, w)
        xcs = [xc for _, _, xc in parts]
        assert all(b >= a for a, b in zip(xcs, xcs[1:]))
        reach = np.maximum.accumulate(x1)
        active, ptr, windows = [], 0, []
        for t, xc in enumerate(xcs):
            active, ptr = _steps(active, ptr, [xc], x0, x1)
            assert ptr == int(np.searchsorted(x0, xc, side="left"))
            live, top, n_top, best = [], None, 0, -1
            s = ptr - 1
            while s >= 0 and not reach[s] < xc:
                if not x1[s] < xc:
                    live.append(s)
                    ip = (xc - x0[s]) / (x1[s] - x0[s])
                    cl = (1.0 - ip) * d0[s] + ip * d1[s] + 0.0
                    if cl > -P.EPS and 0.0 < ip < 1.0:
                        if top is None or cl > top:
                            top, n_top, best = cl, 1, s
                        elif cl == top:
                            n_top += 1
                s -= 1
            assert sorted(live) == sorted(active)
            windows.append((live, ptr))
            want = _list_choice(active, xc, x0, x1, d0, d1)
            if len(live) <= 1:
                assert want == (live[0] if live else -1)
            elif n_top == 1:
                assert want == best
            else:
                # the anchor's list is its live set, its pointer the
                # window's; none before the row's first part
                replays += 1
                q = t - 1
                while q >= 0 and len(windows[q][0]) > 1:
                    q -= 1
                start = windows[q] if q >= 0 else ([], 0)
                rebuilt, _ = _steps(*start, xcs[q + 1:t + 1], x0, x1)
                assert rebuilt == active
    if kind == "ties":
        assert replays > 0


def test_batched_matches_single(rng):
    h, w = 6, 96
    imgs = (rng.random((2, h, w, 3)) * 255).astype(np.uint8)
    nds = rng.random((2, h, w)).astype(np.float32)
    batched = P.polylines_rasterize(torch.from_numpy(imgs),
                                    torch.from_numpy(nds), 2.3, 0.0, 1.0,
                                    True).numpy()
    for i in range(2):
        np.testing.assert_array_equal(batched[i],
                                      _check(imgs[i], nds[i], 2.3, 0.0, 1.0,
                                             True))


def test_divergence_beyond_row_width_rejected():
    img = torch.zeros((2, 8, 3), dtype=torch.uint8)
    nd = torch.full((2, 8), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="row width"):
        P.polylines_rasterize(img, nd, 6.0, 2.0, 1.0, True)


def test_cuda_wrapper_rejects_cpu_tensors(rng):
    img = torch.zeros((4, 8, 3), dtype=torch.uint8)
    nd = torch.zeros((4, 8), dtype=torch.float64)
    before = (P._sort_cuda.launches, P._sweep_cuda.launches)
    with pytest.raises(ValueError):
        P.polylines_cuda(img, nd, 1.0, 0.0, 1.0, True)
    assert (P._sort_cuda.launches, P._sweep_cuda.launches) == before


@pytest.mark.parametrize("balance", [0.0, 0.4, -1.0, 1.0])
@pytest.mark.parametrize("fill", ["polylines_sharp", "polylines_soft"])
def test_create_stereoimages_matches_jax(rng, balance, fill):
    h, w = 10, 48
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depth = (rng.random((h, w)) * 65535).astype(np.uint16)
    modes = list(STEREO_MODES)
    want = j_create(img, depth, 2.5, 0.3, modes, balance, 1.0, fill)
    got = create_stereoimages(img, depth, 2.5, 0.3, modes, balance, 1.0,
                              fill, device="cpu")
    assert len(got) == len(want) == 8
    for m, g, wnt in zip(modes, got, want):
        assert g.dtype == np.uint8, m
        np.testing.assert_array_equal(g, np.asarray(wnt), err_msg=m)


def test_warp_fills_not_ported(rng):
    """The warp fills were the part of ops/stereo.py not ported at first;
    now every fill runs and equals the JAX function's bytes (the warp fills
    in depth: tests/test_torch_port_stereo.py)."""
    img = (rng.random((4, 8, 3)) * 255).astype(np.uint8)
    depth = np.arange(32, dtype=np.uint16).reshape(4, 8)
    for fill in ("none", "naive", "naive_interpolating"):
        got = create_stereoimages(img, depth, 12.5, fill_technique=fill,
                                  device="cpu")
        want = j_create(img, depth, 12.5, fill_technique=fill)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]),
                                      err_msg=fill)


def test_create_stereoimages_defaults_to_the_card(rng):
    """numpy inputs and no device: the card, through resolve_device, which
    raises without CUDA; with a card, K2 runs there."""
    img = (rng.random((6, 32, 3)) * 255).astype(np.uint8)
    depth = (rng.random((6, 32)) * 65535).astype(np.uint16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_stereoimages(img, depth, 2.5)
        return
    before = (P._sort_cuda.launches, P._sweep_cuda.launches)
    got = create_stereoimages(img, depth, 2.5)
    assert (P._sort_cuda.launches, P._sweep_cuda.launches) == \
        (before[0] + 2, before[1] + 2)
    want = create_stereoimages(img, depth, 2.5, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])


def test_cpu_stereo_runs_the_host_kernel(rng, monkeypatch):
    """create_stereoimages on the CPU (the funnel's compute_device "CPU")
    runs the host kernel, one call per eye, and never the plain
    version."""
    def refuse(*a, **kw):
        raise AssertionError("polylines_plain ran outside the tests")
    monkeypatch.setattr(P, "polylines_plain", refuse)
    img = (rng.random((6, 32, 3)) * 255).astype(np.uint8)
    depth = (rng.random((6, 32)) * 65535).astype(np.uint16)
    before = P.polylines_host.launches
    got = create_stereoimages(img, depth, 2.5, modes=["left-right"],
                              device="cpu")
    assert P.polylines_host.launches == before + 2
    want = j_create(img, depth, 2.5, modes=["left-right"])
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


def test_host_kernel_checks_its_inputs():
    img = torch.zeros((4, 8, 3), dtype=torch.uint8)
    nd = torch.zeros((4, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        P.polylines_host(img, nd.float(), 1.0, 0.0, 1.0, True)
    with pytest.raises(ValueError, match="contiguous"):
        P.polylines_host(img, nd.t().contiguous().t(), 1.0, 0.0, 1.0, True)
    with pytest.raises(ValueError, match="row width"):
        P.polylines_host(img, nd, 6.0, 2.0, 1.0, True)


def test_host_build_flags_and_failure(monkeypatch):
    """FMA contraction off and no tuning for the building CPU (the JAX
    package builds with -march=native); a missing compiler raises, it
    never falls back to the plain version."""
    from depthmap_tpu_torch.ops import host_build
    assert "-ffp-contract=off" in host_build.FLAGS
    assert not any(f.startswith("-march") for f in host_build.FLAGS)
    monkeypatch.setattr(host_build, "_loaded", {})
    monkeypatch.setattr(host_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        host_build.load("polylines_host")
    img = torch.zeros((2, 8, 3), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        P.polylines_rasterize(img, torch.zeros((2, 8)), 1.0, 0.0, 1.0, True)
