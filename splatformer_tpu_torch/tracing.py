"""Spans and counters inside the program, off unless a caller turns them on.

    tracing.enable("cuda")
    ... requests or steps ...
    snap = tracing.snapshot()   # after the work
    tracing.disable()

``span(name)`` is a context manager around the work of one layer (the
names are the program's: ``eval_step``, ``refine.enc2``, ``render.bin``,
...; PERF.md lists them); ``count(name, value)`` records a number at the
same boundaries. A span's record holds its name, its parent, the id of the
outermost span above it (one request or one step: every span beneath it
shares the id), its thread (the OS thread id, as a profiler trace gives
it), its host start and end from ``time.time_ns()``
(the clock of a ``torch.profiler`` trace) and, when enabled for a CUDA
device, a pair of CUDA events on the current stream. Nesting is kept per
thread.

Off (the default), ``span`` returns one shared no-op context and ``count``
returns at once: no event, no tensor, no host read. A counter whose value
costs device work is computed by its caller only under ``enabled()``.
Records stay in memory; the events are read and the counters' device
scalars copied to the host only in ``snapshot()``, which waits for the
device.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from splatformer_tpu_torch.kernels import LAUNCHES

_NOOP = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "parent", "id", "thread", "start_ns", "end_ns",
                 "start_ev", "end_ev")


class _State:
    def __init__(self):
        self.on = False
        self.cuda = False
        self.spans: List[_Record] = []
        self.counts: List[tuple] = []
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> List[_Record]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self) -> Optional[torch.cuda.Event]:
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


_STATE = _State()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STATE
        stack = st.stack()
        rec = self.rec = _Record()
        rec.name = self.name
        rec.parent = stack[-1] if stack else None
        rec.id = rec.parent.id if stack else next(st.ids)
        rec.thread = threading.get_native_id()
        rec.end_ns = rec.end_ev = None
        stack.append(rec)
        st.spans.append(rec)
        rec.start_ns = time.time_ns()
        rec.start_ev = st.event()
        return self

    def __exit__(self, *exc) -> None:
        st, rec = _STATE, self.rec
        rec.end_ev = st.event()
        rec.end_ns = time.time_ns()
        st.stack().pop()


def enable(device) -> None:
    """Record spans and counters from now on; on a CUDA ``device`` each
    span also records a pair of CUDA events."""
    _STATE.cuda = torch.device(device).type == "cuda"
    _STATE.on = True


def disable() -> None:
    _STATE.on = False


def enabled() -> bool:
    return _STATE.on


def clear() -> None:
    """Forget every record made so far."""
    _STATE.spans.clear()
    _STATE.counts.clear()


def span(name: str):
    """A context manager that records ``name`` around its body when tracing
    is on, else the shared no-op context."""
    if not _STATE.on:
        return _NOOP
    return _Span(name)


def count(name: str, value) -> None:
    """Record ``value`` (a number, or a device scalar read in
    ``snapshot()``) under ``name``, in the innermost open span's id."""
    if not _STATE.on:
        return
    stack = _STATE.stack()
    _STATE.counts.append((name, value, stack[-1].id if stack else None))


def snapshot() -> Dict[str, Any]:
    """{spans, counters, launches} of everything recorded since the last
    ``clear()``. ``spans``: the closed spans in the order they opened, each
    {name, parent (index into ``spans``, or None), id, thread, start_ns,
    end_ns, ms (the CUDA events' time on a card, else the host's)};
    ``counters``: [{name, value, id}] in recording order; ``launches``: a
    copy of ``kernels.LAUNCHES``. Waits for the device."""
    st = _STATE
    if st.cuda:
        torch.cuda.synchronize()
    closed = [r for r in st.spans if r.end_ns is not None]
    index = {id(r): i for i, r in enumerate(closed)}
    spans = []
    for r in closed:
        ms = (r.start_ev.elapsed_time(r.end_ev) if r.start_ev is not None
              else (r.end_ns - r.start_ns) * 1e-6)
        spans.append({"name": r.name, "parent": index.get(id(r.parent)),
                      "id": r.id, "thread": r.thread,
                      "start_ns": r.start_ns, "end_ns": r.end_ns, "ms": ms})
    counters = [{"name": n, "id": i,
                 "value": v.item() if isinstance(v, torch.Tensor) else v}
                for n, v, i in st.counts]
    return {"spans": spans, "counters": counters, "launches": dict(LAUNCHES)}
