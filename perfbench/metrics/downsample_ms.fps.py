"""Input downsampling's time, mean ms a request of the traced part: the
program's ``refine.downsample`` span where it has one, else the ``refine``
span's own time outside its child spans (the downsampling, the input's
concatenation and the grid's floor; ops/downsample.py is most of it), so
that a program which adds the span keeps the metric's meaning."""
from perfbench.lib import readers


def read(run):
    return readers.downsample_ms(run)
