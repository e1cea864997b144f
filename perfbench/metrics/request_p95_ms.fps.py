"""request_p95_ms.fps: the 95th percentile of serve_fps's request times
(host clock, issue to outputs in host memory) over the requests a traced
run serves after its traced part; per layer for the reason
request_rate.fps gives."""
import numpy as np


def read(run):
    if run.kind != "serve" or not getattr(run, "trace", None):
        return None
    rest = run.latencies_s[run.traced_done:]
    return float(np.percentile(np.asarray(rest) * 1e3, 95)) if rest else None
