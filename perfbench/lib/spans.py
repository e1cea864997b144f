"""Spans around the calls into each layer, from the harness's side: a pair
of CUDA events a span (host clock on the CPU), read once the window has
closed, and the host's epoch-nanosecond bounds of each, with which the
trace labels the device's idle gaps."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Spans:
    """``begin(name)`` / ``end(name)`` pairs; spans of one name do not
    nest. ``ms()`` after the window: {name: [ms of each span]}; ``host``:
    [(name, start ns, end ns)]."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open: Dict[str, tuple] = {}
        self.closed: Dict[str, List[tuple]] = defaultdict(list)
        self.host: List[Tuple[str, int, int]] = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def begin(self, name: str) -> None:
        self.open[name] = (self._mark(), time.time_ns())

    def end(self, name: str) -> None:
        start, start_ns = self.open.pop(name)
        self.closed[name].append((start, self._mark()))
        self.host.append((name, start_ns, time.time_ns()))

    def clear(self) -> None:
        self.closed.clear()
        self.host.clear()

    def ms(self) -> Dict[str, List[float]]:
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.closed.items()}
        return {k: [(b - a) * 1e3 for a, b in v]
                for k, v in self.closed.items()}


def wrap_module(module: torch.nn.Module, spans: Spans, name: str) -> None:
    """A span around every forward of ``module`` (a forward pre-hook and a
    forward hook)."""
    module.register_forward_pre_hook(lambda m, a: spans.begin(name))
    module.register_forward_hook(lambda m, a, o: spans.end(name))


def wrap_function(fn, spans: Spans, name: str):
    """``fn`` with a span around each call."""
    def wrapped(*args, **kwargs):
        spans.begin(name)
        try:
            return fn(*args, **kwargs)
        finally:
            spans.end(name)
    return wrapped
