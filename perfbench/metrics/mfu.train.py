"""The whole step's share of the chip's peak (%): the FLOPs of the traced
forwards (lib/counters.py:model_flops; in training the backward at twice
the forward and LPIPS), each class at its peak, over the median time of
the run's requests or steps."""
from perfbench.lib import readers


def read(run):
    if run.kind != "train":
        return None
    return readers.mfu(run)
