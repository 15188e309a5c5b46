"""host_prep_ms_per_image: the funnel's own ``prepare`` spans
(utils/profiling.py: the host's making of each forward's f32 input, to_rgb,
the stack and the /255) over the unprofiled window, per photo."""


def read(run):
    spans = run.window.spans.get("prepare")
    if not spans or run.window.photos == 0:
        return None
    return 1000.0 * sum(spans) / run.window.photos
