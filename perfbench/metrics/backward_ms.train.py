"""The program's ``backward`` span (the train step's loss.backward():
autograd's kernels through LPIPS, the render and the refiner), mean ms a
step of the traced part."""
from perfbench.lib import readers


def read(run):
    return readers.program_span_ms(run, "backward")
