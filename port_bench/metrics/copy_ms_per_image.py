"""copy_ms_per_image: the device time of host-device copies (Memcpy HtoD
and DtoH, pageable or pinned) in the profiled stretch, per photo."""


def read(run):
    t = run.trace
    if t is None or t.photos == 0:
        return None
    copy_s = sum(d for n, _, d in t.copies if n.startswith("Memcpy")
                 and ("HtoD" in n or "DtoH" in n)) / 1e6
    return 1000.0 * copy_s / t.photos
