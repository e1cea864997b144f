"""The program's ``refine.serialize`` span (ops/serialization.py: the
space-filling-curve codes and their sorts, every order), mean ms a
request of the traced part."""
from perfbench.lib import readers


def read(run):
    return readers.program_span_ms(run, "refine.serialize")
