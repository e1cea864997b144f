"""The device's idle share of the traced part of the window (%): one less
the union of the device's activity intervals over the part's wall time."""
from perfbench.lib import readers


def read(run):
    if run.kind != "serve":
        return None
    return readers.idle_share(run)
