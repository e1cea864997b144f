"""lib/program_trace.py: the trace's reduction with the program's spans
beside the harness's, on a synthetic trace, and the program's records of
a tiny traced run on the CPU grouped by request or step, as the runners
(lib/base.py) take them and the metric readers read them."""
from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import (compare, counters, harness, program_trace,
                           readers, trace)
from perfbench.lib.serve import Serve
from perfbench.lib.train import Train
from perfbench.tests.tiny import tiny_cell
from splatformer_tpu_torch import tracing


class Event:
    """The parts of a kineto event that the reductions read."""

    def __init__(self, name, start, dur, corr, device="CUDA"):
        self._v = (name, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return f"DeviceType.{self._v[4]}"


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


# in a window of 0-100 ns: kernels at 10-20, 40-50, 70-80 and 96-98, a
# copy at 85-90; their launches at 5, 35, 62, 96 and 84
EVENTS = [Event("k_a", 10, 10, 1), Event("k_b", 40, 10, 2),
          Event("k_c", 70, 10, 3), Event("Memcpy HtoD", 85, 5, 4),
          Event("k_d", 96, 2, 5),
          Event("cudaLaunchKernel", 5, 1, 1, "CPU"),
          Event("cudaLaunchKernel", 35, 1, 2, "CPU"),
          Event("cudaLaunchKernel", 62, 1, 3, "CPU"),
          Event("cudaMemcpyAsync", 84, 1, 4, "CPU"),
          Event("cuLaunchKernel", 96, 1, 5, "CPU")]
HARNESS = [("request", 0, 100)]
SNAP = {"spans": [
    {"name": "eval_step", "parent": None, "id": 0, "thread": 7,
     "start_ns": 1, "end_ns": 95, "ms": 9e-5},
    {"name": "refine", "parent": 0, "id": 0, "thread": 7,
     "start_ns": 2, "end_ns": 38, "ms": 3e-5},
    {"name": "refine.enc0", "parent": 1, "id": 0, "thread": 7,
     "start_ns": 30, "end_ns": 37, "ms": 1e-5},
    {"name": "render", "parent": 0, "id": 0, "thread": 7,
     "start_ns": 39, "end_ns": 90, "ms": 5e-5},
    {"name": "render.bin", "parent": 3, "id": 0, "thread": 7,
     "start_ns": 55, "end_ns": 65, "ms": 1e-5}],
    "counters": [], "launches": {}}


def test_reduce_keeps_the_harness_numbers_and_adds_the_programs():
    prof = Prof(EVENTS)
    plain = trace.reduce(prof, (0, 100), HARNESS)
    both = program_trace.reduce(prof, (0, 100), HARNESS, SNAP)
    for key in ("busy_s", "window_s", "kernels", "launches"):
        assert both[key] == plain[key]
    assert plain["launches"] == 4
    assert plain["idle"] == pytest.approx({"request": 63e-9})
    # each gap (0-10, 20-40, 50-70, 80-85, 90-96, 98-100) by the innermost
    # span open at its middle
    assert both["idle"] == pytest.approx({
        "refine": 10e-9, "refine.enc0": 20e-9, "render.bin": 20e-9,
        "render": 5e-9, "eval_step": 6e-9, "request": 2e-9})
    assert both["idle_within"] == pytest.approx({
        "eval_step": 61e-9, "refine": 30e-9, "refine.enc0": 20e-9,
        "render": 25e-9, "render.bin": 20e-9})
    assert both["launches_by_span"] == {"refine": 1, "refine.enc0": 1,
                                        "render.bin": 1, "outside_spans": 1}
    assert both["launches_within"] == {"eval_step": 3, "refine": 2,
                                       "refine.enc0": 1, "render": 1,
                                       "render.bin": 1}
    # the kernels' device time by the spans their launches lie in
    assert both["device_within"] == pytest.approx({
        "eval_step": 30e-9, "refine": 20e-9, "refine.enc0": 10e-9,
        "render": 10e-9, "render.bin": 10e-9})


def test_a_launch_without_a_runtime_record_is_unattributed():
    events = [e for e in EVENTS if e.correlation_id() != 2
              or e.device_type().endswith("CUDA")]
    inner, _ = program_trace.launches_by_span(
        [t for t, _ in program_trace.kernels(events)], SNAP["spans"])
    assert inner["unattributed"] == 1


def test_gaps_are_not_read_off_another_clock():
    assert program_trace.idle_gaps(EVENTS, (20, 100)) == []
    assert program_trace.reduce(Prof(EVENTS), (20, 100), HARNESS,
                                SNAP)["idle_within"] == {}


def test_per_root_groups_by_request():
    snap = {"spans": SNAP["spans"] + [
        {"name": "eval_step", "parent": None, "id": 1, "thread": 7,
         "start_ns": 100, "end_ns": 150, "ms": 0.5},
        {"name": "render.bin", "parent": 5, "id": 1, "thread": 7,
         "start_ns": 110, "end_ns": 120, "ms": 0.25},
        {"name": "render.bin", "parent": 5, "id": 1, "thread": 7,
         "start_ns": 120, "end_ns": 130, "ms": 0.125}],
        "counters": [{"name": "refine.rows.enc0", "value": 8, "id": 0},
                     {"name": "refine.rows.enc0", "value": 9, "id": 1}]}
    ms, counts = program_trace.per_root(snap)
    assert [sorted(m) for m in ms] == [
        ["eval_step", "refine", "refine.enc0", "render", "render.bin"],
        ["eval_step", "render.bin"]]
    assert ms[1]["render.bin"] == 0.375
    assert counts == [{"refine.rows.enc0": 8}, {"refine.rows.enc0": 9}]


def traced_run(workload):
    """A tiny traced run of ``workload`` on the CPU, as harness.run drives
    it: the runner's measures, its checks and the run record the readers
    get."""
    cell = tiny_cell(workload)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        kind = cell["traffic"]["kind"]
        d = {"serve": Serve, "train": Train}[kind](cell, 2 ** 31 + 77, "cpu",
                                                   True)
        d.setup()
        d.window(0.5)
        measured = d.measured()
        d.free()
        checks = compare.verdict(d.numbers(), cell["limits"])
    finally:
        torch.set_num_threads(n)
    assert not tracing.enabled()
    rec = SimpleNamespace(setup_s=1.0, peak_bytes=0, cell=cell, **measured)
    return cell, measured, checks, rec


@pytest.mark.parametrize("workload,want", [
    ("serve_tome", ("render.project", "render.bin", "render", "refine",
                    "refine.serialize", "attention.merge",
                    "attention.unmerge", "mlp.merge", "mlp.unmerge")),
    ("train_flash", ("backward", "loss.lpips", "optimizer", "refine",
                     "refine.serialize", "render"))])
def test_a_tiny_traced_run_records_what_the_readers_read(workload, want):
    """The program's tracer, turned on by a traced run: every request or
    step of the traced part holds each span the span metrics read and the
    counters of every stage (the ``refine.*`` counters: the render counts
    the views it projected besides)."""
    cell, measured, checks, _ = traced_run(workload)
    assert compare.passed(checks), checks
    ms, counts = measured["program_spans_ms"], measured["program_counters"]
    assert len(ms) == measured["traced_done"] > 0
    stages = len(cell["config"]["model"]["backbone"]["enc_depths"]) * 2 - 1
    for m, c in zip(ms, counts):
        assert all(m.get(name, 0) > 0 for name in want), m
        assert len([k for k in c if k.startswith("refine.")]) == 3 * stages
        assert all(c[f"refine.points.{s}"] <= c[f"refine.rows.{s}"]
                   for s in ("enc0", "dec0"))
    assert isinstance(measured["trace"]["device_within"], dict)


@pytest.mark.parametrize("workload,metric,span", [
    ("serve_flash", "serialize_ms.serve", "refine.serialize"),
    ("serve_render", "serialize_ms.render", "refine.serialize"),
    ("train_flash", "backward_ms.train", "backward"),
    ("train_flash_f32", "backward_ms.train_f32", "backward")])
def test_the_program_span_metrics_read_a_tiny_traced_run(workload, metric,
                                                         span):
    """The metrics that read the program's spans give the mean a request or
    step of the traced part, and the helpers read its counters; an
    untraced run's record gives none of them."""
    _, measured, _, rec = traced_run(workload)
    names = [m["name"] for m in harness.metrics_for(
        harness.load_benchmark(), workload, True)]
    assert metric in names
    v = harness.reader(metric)(rec)
    ms = measured["program_spans_ms"]
    assert v == pytest.approx(sum(m[span] for m in ms) / len(ms)) and v > 0
    assert readers.program_counter(rec, "refine.rows.enc0") == 2048
    assert readers.program_span_ms(rec, "no.such.span") is None
    untraced = SimpleNamespace(kind=rec.kind, cell=rec.cell)
    assert harness.reader(metric)(untraced) is None
    assert readers.device_within_s(untraced, span) is None


def test_self_ms_leaves_out_the_spans_directly_beneath():
    assert program_trace.self_ms(SNAP) == [pytest.approx({
        "eval_step": 1e-5, "refine": 2e-5, "refine.enc0": 1e-5,
        "render": 4e-5, "render.bin": 1e-5})]


def test_the_downsampling_metrics_read_a_tiny_traced_run():
    """serve_fps's per-layer metrics: ``downsample_ms.fps`` reads the
    ``refine`` span's own time (or a ``refine.downsample`` span where the
    program has one), ``fps_roofline.fps`` FPS's and the nearest search's
    least time at each request's live points and picks over it, and
    ``mfu.fps`` adds their FP32 operations to the forward's FLOPs."""
    cell, measured, checks, rec = traced_run("serve_fps")
    assert compare.passed(checks), checks
    own = [r["refine"] for r in measured["program_self_ms"]]
    assert len(own) == measured["traced_done"] > 0
    ms = harness.reader("downsample_ms.fps")(rec)
    assert ms == pytest.approx(sum(own) / len(own)) and ms > 0
    m = int(cell["config"]["scene"]["pad_to"] * 0.35)
    lives = [r["live"] for r in rec.stage_counts]
    bound = sum(counters.fps_bound_s(n, m) + counters.nearest_bound_s(n, m)
                for n in lives) / len(lives)
    assert readers.downsample_bound_s(rec) == pytest.approx(bound)
    roof = harness.reader("fps_roofline.fps")(rec)
    assert roof == pytest.approx(100 * bound / (ms * 1e-3)) and 0 < roof < 100
    spanned = SimpleNamespace(**vars(rec))
    spanned.program_spans_ms = [dict(r, **{"refine.downsample": 5.0})
                                for r in rec.program_spans_ms]
    assert harness.reader("downsample_ms.fps")(spanned) == 5.0
    # the CPU trace has no device time: give it some to read mfu
    busy = SimpleNamespace(**vars(rec))
    busy.trace = dict(rec.trace, busy_s=1.0)
    ops = sum(counters.fps_work(n, m)[0] + counters.nearest_work(n, m)[0]
              for n in lives) / len(lives)
    gain = 100 * ops / counters.PEAK_F32 / statistics.median(rec.latencies_s)
    assert harness.reader("mfu.fps")(busy) == pytest.approx(
        readers.mfu(busy) + gain)
    _, _, _, flash = traced_run("serve_flash")
    assert readers.downsample_ms(flash) is None
    assert readers.downsample_bound_s(flash) is None


def test_the_fps_request_metrics_leave_out_the_traced_requests():
    """``request_rate.fps`` and ``request_p95_ms.fps`` read only the
    requests a traced run serves after its traced part; an untraced run,
    or one whose window closed inside the traced part, gives neither."""
    run = SimpleNamespace(kind="serve", trace={"busy_s": 1.0},
                          latencies_s=[4.0, 4.2, 2.0, 2.5, 3.0],
                          traced_done=2)
    rate = harness.reader("request_rate.fps")
    p95 = harness.reader("request_p95_ms.fps")
    assert rate(run) == pytest.approx(3 / 7.5)
    assert p95(run) == pytest.approx(2950.0)
    assert {"request_rate.fps", "request_p95_ms.fps"} <= {
        m["name"] for m in harness.metrics_for(harness.load_benchmark(),
                                               "serve_fps", True)}
    inside = SimpleNamespace(**dict(vars(run), traced_done=5))
    untraced = SimpleNamespace(kind="serve", latencies_s=run.latencies_s)
    for r in (inside, untraced):
        assert rate(r) is None and p95(r) is None
