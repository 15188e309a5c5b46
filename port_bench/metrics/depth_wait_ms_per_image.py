"""depth_wait_ms_per_image: the predictor's own ``download`` spans
(utils/profiling.py: the host blocked until the card has finished the
forward, then the depth map's copy to the host) over the unprofiled
window, per photo."""


def read(run):
    spans = run.window.spans.get("download")
    if not spans or run.window.photos == 0:
        return None
    return 1000.0 * sum(spans) / run.window.photos
