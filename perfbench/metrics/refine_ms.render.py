"""Mean ms a request of the FeaturePredictor span (CUDA events at its
forward pre-hook and forward hook) over the window."""
from perfbench.lib import readers


def read(run):
    return readers.span_mean_ms(run, "refine") if run.kind == "serve" else None
