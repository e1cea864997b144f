"""K3-fwd's share of its roofline (%): the least time of the traced
forwards' K3 calls (lib/counters.py:k3_bound, float32 as three TF32
products) over the device time of the attention_fwd kernels in the traced
part."""
from perfbench.lib import readers


def read(run):
    return readers.k3_roofline(run, False) if run.kind == "serve" else None
