"""request_p90_s: the 90th percentile of all of the window's request
latencies, in seconds (host clock around a synchronised call)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 90)) if run.latencies else None
