"""images_per_s: photos whose every requested output was yielded, over
the window's wall time (host clock; the window ends at its last job's
end)."""


def read(run):
    w = run.window
    return w.photos / w.seconds if w.seconds > 0 else None
