"""mfu.train for the float32 recipe: the traced steps' FLOPs (three times
the forward's, and LPIPS), the blocks at the FP32 peak and K3 as split
TF32, over the median step (lib/readers.py:mfu)."""
from perfbench.lib import readers


def read(run):
    return readers.mfu(run) if run.kind == "train" else None
