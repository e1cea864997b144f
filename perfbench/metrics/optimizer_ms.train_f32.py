"""Mean ms a float32 step of the span around the optimizer's step() (clip
and Adam) over the window."""
from perfbench.lib import readers


def read(run):
    return (readers.span_mean_ms(run, "optimizer") if run.kind == "train"
            else None)
