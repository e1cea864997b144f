"""The program's own spans and counters (``splatformer_tpu_torch.tracing``)
in a traced run: the trace's reduction with them beside the harness's
spans, and their records grouped by request or step.

The program's tracer is off unless its caller turns it on. A traced run
(lib/base.py) calls the tracer's ``enable(device)`` before the warm-up, its
``clear()`` where the traced part starts and its ``snapshot()`` where it
ends, then hands the snapshot to ``reduce`` (in place of lib/trace.py's
``reduce``) and to ``per_root``. Nothing here imports the program."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.lib import trace

_DEVICE = "CUDA"


def host_spans(snap: Dict) -> List[Tuple[str, int, int]]:
    """The program's spans as lib/trace.py takes the harness's: (name,
    start ns, end ns)."""
    return [(s["name"], s["start_ns"], s["end_ns"]) for s in snap["spans"]]


def _on_device(e) -> bool:
    return str(e.device_type()).endswith(_DEVICE)


def idle_gaps(events, window_ns: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The device's idle intervals inside the window (epoch ns), as
    lib/trace.py:reduce finds them; none where the trace's clock and the
    host's disagree."""
    w0, w1 = window_ns
    busy = trace._union([(e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in events if _on_device(e)
                         and not e.name().startswith("pb:")])
    if not busy or busy[0][0] < w0 or busy[-1][1] > w1:
        return []
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps


def _innermost(times: List[int], spans: List[Dict]) -> List[Optional[int]]:
    """For each host time, the index of the innermost program span open at
    it (start <= t < end; the latest opened), or None: one sweep over the
    spans, which nest on the program's thread."""
    starts = sorted(range(len(spans)), key=lambda i: spans[i]["start_ns"])
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    k = 0
    for j in sorted(range(len(times)), key=lambda j: times[j]):
        t = times[j]
        while k < len(starts) and spans[starts[k]]["start_ns"] <= t:
            i = starts[k]
            k += 1
            while stack and spans[stack[-1]]["end_ns"] <= spans[i]["start_ns"]:
                stack.pop()
            stack.append(i)
        while stack and spans[stack[-1]]["end_ns"] <= t:
            stack.pop()
        out[j] = stack[-1] if stack else None
    return out


def _names_up(spans: List[Dict]):
    """index -> the names of the span and of every span above it."""
    cache: Dict[int, frozenset] = {}

    def up(i: int) -> frozenset:
        if i not in cache:
            p = spans[i]["parent"]
            cache[i] = frozenset({spans[i]["name"]}) | (
                up(p) if p is not None else frozenset())
        return cache[i]
    return up


def idle_within(gaps: List[Tuple[int, int]], spans: List[Dict]
                ) -> Dict[str, float]:
    """{name: idle seconds of the gaps whose middle lies inside a span of
    that name}, at any depth; a gap counts once a name."""
    out: Dict[str, float] = defaultdict(float)
    up = _names_up(spans)
    inner = _innermost([(a + b) // 2 for a, b in gaps], spans)
    for (a, b), i in zip(gaps, inner):
        if i is not None:
            for name in up(i):
                out[name] += (b - a) * 1e-9
    return dict(out)


def kernels(events) -> List[Tuple[int, float]]:
    """(host ns of its launch, device seconds) of each kernel in the trace:
    the launch is the record of its launch call (``cudaLaunchKernel``,
    ``cuLaunchKernel``) that shares the kernel's correlation id. Copies
    and memsets are left out, as lib/trace.py leaves them out of
    ``launches``; a kernel whose launch has no record gives -1. The
    records carry no usable thread (a CUDA-only trace gives every one the
    same), so a launch is placed by its time alone."""
    host = {}
    for e in events:
        if not _on_device(e) and e.correlation_id():
            host.setdefault(e.correlation_id(), e.start_ns())
    return [(host.get(e.correlation_id(), -1), e.duration_ns() * 1e-9)
            for e in events
            if _on_device(e) and not e.name().startswith(trace._NOT_KERNELS)
            and not e.name().startswith("pb:")]


def device_within(ks: List[Tuple[int, float]], spans: List[Dict]
                  ) -> Dict[str, float]:
    """{name: device seconds of the kernels launched inside a span of that
    name, at any depth}, from ``kernels``' (launch ns, seconds); a kernel
    launched while autograd's thread runs the backward counts in
    ``backward``, as in ``launches_by_span``."""
    out: Dict[str, float] = defaultdict(float)
    up = _names_up(spans)
    for (t, sec), i in zip(ks, _innermost([t for t, _ in ks], spans)):
        if t >= 0 and i is not None:
            for name in up(i):
                out[name] += sec
    return dict(out)


def launches_by_span(times: List[int], spans: List[Dict]
                     ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """({name: launches whose innermost open program span is that span},
    {name: launches inside a span of that name at any depth}). The
    program's spans are open on the thread that calls it, and autograd's
    thread launches the backward while that thread waits in ``backward``,
    so the backward's launches count there. A launch outside every span
    counts as ``outside_spans``, one without a runtime record as
    ``unattributed``."""
    inner: Dict[str, int] = defaultdict(int)
    within: Dict[str, int] = defaultdict(int)
    up = _names_up(spans)
    for t, i in zip(times, _innermost(times, spans)):
        if t < 0:
            inner["unattributed"] += 1
        elif i is None:
            inner["outside_spans"] += 1
        else:
            inner[spans[i]["name"]] += 1
            for name in up(i):
                within[name] += 1
    return dict(inner), dict(within)


def reduce(prof, window_ns: Tuple[int, int],
           spans: List[Tuple[str, int, int]], snap: Dict) -> Dict:
    """lib/trace.py:reduce with the program's spans: ``busy_s``,
    ``window_s``, ``kernels`` and ``launches`` as it gives them, ``idle``
    labelled by the innermost span open at each gap's middle, the
    harness's or the program's, and besides ``idle_within`` {name: s},
    ``launches_by_span`` {innermost name: n}, ``launches_within`` {name:
    n, at any depth} and ``device_within`` {name: kernel seconds launched
    inside it, at any depth}."""
    out = trace.reduce(prof, window_ns, list(spans) + host_spans(snap))
    events = list(prof.profiler.kineto_results.events())
    out["idle_within"] = idle_within(idle_gaps(events, window_ns),
                                     snap["spans"])
    ks = kernels(events)
    out["launches_by_span"], out["launches_within"] = launches_by_span(
        [t for t, _ in ks], snap["spans"])
    out["device_within"] = device_within(ks, snap["spans"])
    return out


def per_root(snap: Dict) -> Tuple[List[Dict[str, float]],
                                  List[Dict[str, float]]]:
    """(program_spans_ms, program_counters): for each request or step (the
    program's outermost spans, in order), {span name: summed ms} and
    {counter name: value}."""
    order: List[int] = []
    ms: Dict[int, Dict[str, float]] = {}
    counts: Dict[int, Dict[str, float]] = {}
    for s in snap["spans"]:
        if s["id"] not in ms:
            order.append(s["id"])
            ms[s["id"]], counts[s["id"]] = defaultdict(float), {}
        ms[s["id"]][s["name"]] += s["ms"]
    for c in snap["counters"]:
        if c["id"] in counts:
            counts[c["id"]][c["name"]] = c["value"]
    return [dict(ms[i]) for i in order], [counts[i] for i in order]


def self_ms(snap: Dict) -> List[Dict[str, float]]:
    """For each request or step (as ``per_root``), {span name: summed ms
    of the span less the ms of the spans directly beneath it}: its own
    time."""
    spans = snap["spans"]
    own = [s["ms"] for s in spans]
    for s in spans:
        if s["parent"] is not None:
            own[s["parent"]] -= s["ms"]
    order: List[int] = []
    out: Dict[int, Dict[str, float]] = {}
    for s, ms in zip(spans, own):
        if s["id"] not in out:
            order.append(s["id"])
            out[s["id"]] = defaultdict(float)
        out[s["id"]][s["name"]] += ms
    return [dict(out[i]) for i in order]
