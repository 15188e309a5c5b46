"""stereo_ms_per_image: the funnel's own ``stage("stereo")`` spans
(utils/profiling.py) over the unprofiled window, per photo."""


def read(run):
    spans = run.window.spans.get("stereo")
    if not spans or run.window.photos == 0:
        return None
    return 1000.0 * sum(spans) / run.window.photos
