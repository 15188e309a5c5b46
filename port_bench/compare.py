"""The check that decides ``correct``: what the window produced against
the plain reference, on a sample drawn from the seed.

Depth: every kept photo's uint16 map against the reference's, computed
in f32 (TF32 off) from the same seeded weights and the same photo; the
numbers are the worst photo's gap, as a share of the 16-bit range.
Stereo: the reference's eyes, from the photo and the program's own uint16
map (the stage follows the program's map, whose own check is the depth
number), on rows drawn from the seed, composed as each requested mode
and compared byte for byte with the program's outputs.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

FULL = 65535.0
DEPTH_NUMBERS = ("depth_rms", "depth_max", "depth_fit_vs_bf16",
                 "depth_range_off")
LIVE_LEVEL = 0.01   # of the 16-bit range
LIVE_SHARE = 0.01   # of the pixels


def reference_maps(cell, leaves, seed: int, device, photos, numerics: str
                   ) -> List[np.ndarray]:
    """The reference's uint16 map of each photo."""
    import torch
    from port_bench import weights
    from port_bench.harness import net_size
    from port_bench.reference import common
    common.f32_matmuls()
    w = weights.make(leaves, seed, device, dtype=torch.float32)
    model = cell.reference().build(cell.config, w, common.Numerics(numerics))
    out = []
    for img in photos:
        h, wd = img.shape[:2]
        nw, nh = net_size(cell, wd, h)
        net_hw = common.net_input_size(cell.config, wd, h, nw, nh)
        raw = model.raw(img, net_hw)
        out.append(common.to_uint16(raw, cell.config["predicts_depth"]))
    del model, w
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _fit_residual(p: np.ndarray, r: np.ndarray):
    """The least-squares affine fit of map p on map r (both as shares of
    the 16-bit range): (slope, RMS of what the fit leaves)."""
    pf = p.astype(np.float64).ravel() / FULL
    rf = r.astype(np.float64).ravel() / FULL
    a = np.stack([rf, np.ones_like(rf)], 1)
    coef = np.linalg.lstsq(a, pf, rcond=None)[0]
    return float(coef[0]), float(np.sqrt(np.mean((pf - a @ coef) ** 2)))


def depth_numbers(program: List[np.ndarray], reference: List[np.ndarray],
                  rounded: List[np.ndarray]) -> Dict[str, float]:
    """The worst photo's gaps from the f32 reference.

    ``depth_rms`` and ``depth_max``: the plain gaps, as shares of the
    16-bit range, for the record.  ``depth_fit_vs_bf16``, which the check
    compares: what a least-squares affine fit of the program's map on the
    reference's leaves, as a multiple of what it leaves of ``rounded``
    (the reference with every product's operands rounded to bf16).  Each
    map is normalized by its own range, which a random-weight net often
    sets by one far pixel, so one pixel's rounding rescales the whole map:
    plain gaps then swing tenfold from photo to photo, for the program
    and its control alike, and a ratio of plain gaps swings with that one
    pixel.  The fit takes the rescaling out of both sides and leaves the
    per-pixel rounding, which the bf16-rounded reference measures for
    each photo.  A fit with a slope of 0 or less (an inverted or constant
    map) counts as 1e9.  ``depth_range_off``: how far the program's map
    falls short of spanning 0 to 65535, which the finalize states for
    every map that is not flat; with the fit it holds the scale.

    A photo whose reference map is dead but for a few pixels (fewer than
    ``LIVE_SHARE`` of them above ``LIVE_LEVEL`` of the range: the net's
    last ReLU let almost nothing through) carries no map to compare, and
    is left out by this rule on the reference alone.  Whether a map is
    dead is mostly the seed's: the last 1x1 convolution's 32 weights
    decide it for every photo alike.  Where no kept photo is left, no
    depth number is compared (each reads 0) and the run says so."""
    worst = dict.fromkeys(DEPTH_NUMBERS, 0.0)
    compared = 0
    for p, r, b in zip(program, reference, rounded):
        if p.shape != r.shape:
            return dict.fromkeys(DEPTH_NUMBERS, 1e9)
        if live_share(r) < LIVE_SHARE:
            continue
        compared += 1
        d = (p.astype(np.float64) - r.astype(np.float64)) / FULL
        got = {"depth_rms": float(np.sqrt(np.mean(d * d))),
               "depth_max": float(np.abs(d).max())}
        slope, left = _fit_residual(p, r)
        _, left_b = _fit_residual(b, r)
        got["depth_fit_vs_bf16"] = left / max(left_b, 1.0 / FULL) \
            if slope > 0 else 1e9
        got["depth_range_off"] = 0.0 if r.max() == r.min() else float(
            int(p.min()) + (int(FULL) - int(p.max())))
        for k in DEPTH_NUMBERS:
            worst[k] = max(worst[k], got[k])
    if compared == 0:
        from port_bench.harness import log
        log("no kept photo has a live reference map: depth not compared")
    return worst


def live_share(r: np.ndarray) -> float:
    """The share of a map's pixels above ``LIVE_LEVEL`` of the range."""
    return float(np.mean(r > LIVE_LEVEL * FULL))


def stereo_numbers(kept: List[dict], opts: dict, rng, photos: int,
                   rows: int) -> Dict[str, float]:
    """Bytes of the program's stereo outputs that differ from the
    reference's on ``rows`` rows of each of the first ``photos`` kept
    photos."""
    from port_bench.reference import stereo
    off = 0
    for item in kept[:photos]:
        img = item["image"]
        depth = item["outputs"]["depth"]
        pick = sorted(rng.choice(img.shape[0], rows, replace=False).tolist())
        eyes = stereo.eye_rows(
            img, depth, pick, float(opts["stereo_divergence"]),
            float(opts.get("stereo_separation", 0.0)),
            float(opts.get("stereo_offset_exponent", 1.0)),
            float(opts.get("stereo_balance", 0.0)),
            opts["stereo_fill_algo"] == "polylines_sharp")
        for mode in opts["stereo_modes"]:
            want = stereo.compose(mode, eyes["left"], eyes["right"])
            got = item["outputs"][mode][pick]
            if got.shape != want.shape:
                off += want.size
            else:
                off += int(np.count_nonzero(got != want))
    return {"stereo_bytes_off": float(off)}


def check(bench) -> Dict[str, dict]:
    """Each number the cell's limits name, with its limit; the others are
    printed for the record."""
    cell = bench.cell
    limits = cell.limits()
    # nothing kept: every comparison fails
    numbers = dict.fromkeys(DEPTH_NUMBERS, 1e9)
    if bench.opts.get("gen_stereo"):
        numbers["stereo_bytes_off"] = 1.0
    if bench.kept:
        photos = [k["image"] for k in bench.kept]
        ref = reference_maps(cell, bench.leaves, bench.seed, bench.device,
                             photos, "f32")
        rounded = reference_maps(cell, bench.leaves, bench.seed,
                                 bench.device, photos, "bf16")
        numbers.update(depth_numbers(
            [k["outputs"]["depth"] for k in bench.kept], ref, rounded))
        if bench.opts.get("gen_stereo"):
            chk = cell.traffic["check"]
            numbers.update(stereo_numbers(
                bench.kept, bench.opts, bench.rng,
                int(chk["stereo_photos"]), int(chk["stereo_rows"])))
    numbers["photos_short"] = float(
        int(cell.traffic["check"]["photos"]) - len(bench.kept))
    from port_bench.harness import log
    log("numbers", {k: v for k, v in numbers.items()})
    out = {}
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"the limits name {name!r}, which the check "
                           "does not compute")
        out[name] = {"value": numbers[name], "limit": float(limit)}
    return out
