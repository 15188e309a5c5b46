"""k1_roofline: the least time of the stretch's attention work at the
card's published peaks (each call: the larger of 4 B H N Nk D over the
tensor rate and its q, k, v, output and bias bytes over the memory
bandwidth), over the device time of the kernels that compute attention:
K1's bodies and pre-pass, and the library attention kernels, so the share
reads the same work whichever kernel does it."""
from port_bench import work

ATTENTION_KERNELS = ("flash_fwd", "split_kv_f32", "fmha", "flash_attn",
                     "efficient_attention", "attention_kernel", "sdpa")


def read(run):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    device_s = t.seconds_of(ATTENTION_KERNELS)
    if device_s <= 0:
        return None
    cfg = run.cell.config
    calls = work.calls_for(
        t.forwards,
        lambda b: run.work.attention_per_forward(cfg, run.net_hw, b))
    least = sum(work.least_seconds(c, run.peaks[cfg["dtype"]],
                                   run.peaks["hbm_bps"]) for c in calls)
    return 100.0 * least / device_s
