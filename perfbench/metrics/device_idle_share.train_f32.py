"""The device's idle share of the traced part of float32 training (%): one
less the union of the device's activity intervals over the part's wall
time."""
from perfbench.lib import readers


def read(run):
    return readers.idle_share(run) if run.kind == "train" else None
