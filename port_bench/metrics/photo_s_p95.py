"""photo_s_p95: the 95th percentile (linear between ranks) of the
window's job wall times, from the funnel call to its last yielded
output, where a job is one photo; absent for jobs of several photos."""
import sys

import numpy as np


def read(run):
    if int(run.cell.traffic["photos_per_job"]) != 1 or not run.window.job_s:
        return None
    print(f"photo_s_p95 over {len(run.window.job_s)} jobs", file=sys.stderr)
    return float(np.percentile(run.window.job_s, 95))
