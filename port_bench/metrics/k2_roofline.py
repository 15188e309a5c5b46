"""k2_roofline: the bytes bound of every eye the stretch rasterized (the
uint8 photo and its normalized depth in f64 read once, the uint8 eye
written once) at the card's memory bandwidth, over the device time of
K2's sort and sweep."""

K2_KERNELS = ("polylines_sort", "polylines_sweep")


def read(run):
    t = run.trace
    if t is None or run.peaks is None or \
            not run.cell.traffic.get("options", {}).get("gen_stereo"):
        return None
    device_s = t.seconds_of(K2_KERNELS)
    eyes = t.launches.get("k2_sweep", 0)
    if device_s <= 0 or eyes == 0:
        return None
    photo = run.cell.traffic["photo"]
    pixels = photo["width"] * photo["height"]
    least = eyes * pixels * (3 + 8 + 3) / run.peaks["hbm_bps"]
    return 100.0 * least / device_s
