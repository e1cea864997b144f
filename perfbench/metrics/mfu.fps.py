"""The whole request's share of the chip's peak (%), as ``mfu.serve``, with
input downsampling's own FP32 work (lib/counters.py:fps_work and
nearest_work at each traced request's live points and picks) counted at
the FP32 peak beside the forward's FLOPs."""
from perfbench.lib import readers


def read(run):
    if run.kind != "serve":
        return None
    return readers.mfu(run, downsampling=True)
