"""setup_s: from the start of run.py to the window's start: imports,
inputs, the predictor's build, the seeded weights, the warm-up job (and,
in a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
