"""p95_ms: the 95th percentile of submit → answer over every request of
the window, ms (host clock)."""

import numpy as np


def read(run):
    if not len(run.latency_s):
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3
