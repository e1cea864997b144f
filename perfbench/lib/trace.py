"""The reduction of a ``torch.profiler`` trace of the first requests or
steps of the window. The profiler records the device's activity only
(CUPTI), which keeps its cost on the host small: busy time is the union of
the device's activity intervals, the window is the host clock's, and the
device time and count are summed by kernel name. Each idle gap between
activity is labelled by the innermost harness span (``pb:<name>``) the host
had open at the middle of the gap, from the spans' host timestamps, which
share the trace's clock (epoch nanoseconds)."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

_NOT_KERNELS = ("Memcpy", "Memset")


def profiler(device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(prof: torch.profiler.profile, window_ns: Tuple[int, int],
           spans: List[Tuple[str, int, int]]) -> Dict:
    """{busy_s, window_s, kernels {name: [count, seconds]}, launches,
    idle {label: seconds}} of the traced part, ``window_ns`` its host-clock
    bounds and ``spans`` the host's (name, start ns, end ns) inside it."""
    w0, w1 = window_ns
    device = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and \
                not e.name().startswith("pb:"):
            device.append((e.name(), e.start_ns(),
                           e.start_ns() + e.duration_ns()))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in device:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) * 1e-9
    busy = _union([(a, b) for _, a, b in device])
    busy_ns = sum(b - a for a, b in busy)
    # the host clock and the trace's agree when the activity lies inside
    # the host's window; else the gaps cannot be labelled
    same_clock = bool(busy) and busy[0][0] >= w0 and busy[-1][1] <= w1
    idle: Dict[str, float] = defaultdict(float)
    if same_clock:
        prev = w0
        for a, b in busy + [(w1, w1)]:
            if a > prev:
                mid = (prev + a) // 2
                inner = [(s, n) for n, s, e in spans if s <= mid < e]
                idle[max(inner)[1] if inner else "between_spans"] += \
                    (a - prev) * 1e-9
            prev = max(prev, b)
    else:
        idle["unlabelled"] = max(0, (w1 - w0) - busy_ns) * 1e-9
    launches = sum(c for name, (c, _) in kernels.items()
                   if not name.startswith(_NOT_KERNELS))
    return {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernels": dict(kernels), "launches": launches,
            "idle": dict(idle)}


def breakdown(reduced: Dict, top: int = 10) -> Dict[str, List]:
    """The contract's ``breakdown``: the device operations with the most
    time and the idle time by what the host was doing."""
    ops = sorted(((n[:160], s) for n, (_, s) in reduced["kernels"].items()),
                 key=lambda x: -x[1])[:top]
    idle = sorted(reduced["idle"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
