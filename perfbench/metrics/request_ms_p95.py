"""request_ms_p95: the 95th percentile of every request's time in the
window, from its issue to its outputs in host memory (host clock)."""
import numpy as np


def read(run):
    if run.kind != "serve" or not run.done:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
