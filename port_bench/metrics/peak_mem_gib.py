"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(run):
    b = run.window.peak_bytes
    return None if b is None else b / 2**30
