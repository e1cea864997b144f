"""The program's ``backward`` span in float32 training (loss.backward():
autograd's kernels through LPIPS, the render and the refiner in float32),
mean ms a step of the traced part."""
from perfbench.lib import readers


def read(run):
    return readers.program_span_ms(run, "backward")
