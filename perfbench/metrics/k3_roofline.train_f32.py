"""K3's share of its roofline in float32 training (%): the least time of
the traced steps' split-TF32 K3-fwd and K3-bwd calls over the device time
of the attention_fwd and attention_bwd kernels in the traced part."""
from perfbench.lib import readers


def read(run):
    return readers.k3_roofline(run, True) if run.kind == "train" else None
