"""The port's tracer (splatformer_tpu_torch/tracing.py): off, it records
nothing and hands out one shared no-op context; on, one eval step and one
train step of a tiny PTv3 give the span tree the program promises, its
counters equal the benchmark harness's stage counts and the backbone's
diagnostics, and the outputs do not move by a bit.

This file imports torch and the port only (no JAX). On a machine with an
NVIDIA GPU:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q

runs the card tests too: no host synchronisation added by tracing, and
the spans on the clock of a CUDA-only torch.profiler trace.
"""
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch import tracing  # noqa: E402
from splatformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from splatformer_tpu_torch.data.synthetic import (orbit_cameras,  # noqa: E402
                                                  random_scene)
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    FeaturePredictor, init_weights)
from splatformer_tpu_torch.models.lpips import LPIPS  # noqa: E402
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training.optim import build_optimizer  # noqa: E402
from splatformer_tpu_torch.training.train_step import (  # noqa: E402
    SceneBatch, make_eval_step, make_train_step)

TINY_PTV3 = dict(
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(2, 2, 4),
    enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(2, 2), dec_patch_size=(16, 16), stride=(1, 2),
    drop_path=0.1, pool_capacity_factors=(1.0, 0.75))
TOME = {"tome": "tome", "r": 0.5, "tome_mlp": True, "tome_attention": True}
RCFG = RasterizeConfig(max_intersects=2 ** 12, tiles_per_gauss=16)
MERGES = ("attention.merge", "attention.unmerge", "mlp.merge", "mlp.unmerge")


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def tiny_model(info, device="cpu", seed=0):
    with torch.device(device):
        model = FeaturePredictor(sh_degree=1, grid_resolution=64,
                                 backbone_kwargs=TINY_PTV3,
                                 additional_info=dict(info))
    init_weights(model, torch.Generator().manual_seed(seed), zeroinit=False)
    return model.to(device)


def tiny_batch(device="cpu"):
    scene = random_scene(np.random.default_rng(3), 256, 1, 230,
                         device=device)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(1)).to(device)
    return SceneBatch(scene=scene,
                      cameras=orbit_cameras(2, 32, 32, device=device),
                      images=images,
                      background=torch.zeros(3, device=device))


def tiny_train_step(info, device="cpu"):
    model = tiny_model(info, device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        lpips = LPIPS().to(device)
    step = make_train_step(model, build_optimizer(model, {"base": 1e-3}),
                           RCFG, lpips_loss_weight=1.0, lpips=lpips)
    return model, step


def refine_tree(merged):
    """The refine's subtree: (name, [children]) in the order they open."""
    blocks = list(MERGES) if merged else []

    def stage(name, pooled):
        kids = [("refine.neighbor_map", [])] if pooled else []
        return (name, kids + [(m, []) for m in blocks])
    return ("refine", [
        ("refine.serialize", []),
        ("refine.embed", [("refine.neighbor_map", [])]),
        stage("refine.enc0", False), stage("refine.enc1", True),
        stage("refine.enc2", True), stage("refine.dec1", False),
        stage("refine.dec0", False), ("refine.heads", [])])


RENDER_TREE = ("render", [("render.project", []), ("render.bin", []),
                          ("render.gather", []), ("render.composite", [])])


def tree_of(spans):
    """[(name, [children])] of the roots in ``spans`` (a snapshot's)."""
    kids = {i: [] for i in range(len(spans))}
    roots = []
    for i, s in enumerate(spans):
        (roots if s["parent"] is None else kids[s["parent"]]).append(i)

    def build(i):
        return (spans[i]["name"], [build(k) for k in kids[i]])
    return [build(i) for i in roots]


def assert_nested(spans):
    """Each span inside its parent, with its parent's id and thread, and
    siblings one after another."""
    last_end = {}
    for s in spans:
        p = s["parent"]
        assert s["start_ns"] <= s["end_ns"]
        if p is not None:
            par = spans[p]
            assert par["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= par["end_ns"], (par["name"], s["name"])
            assert s["id"] == par["id"] and s["thread"] == par["thread"]
        assert s["start_ns"] >= last_end.get(p, 0)
        last_end[p] = s["end_ns"]


def test_off_records_nothing():
    assert tracing.span("render") is tracing.span("refine.enc0")
    model = tiny_model({})
    make_eval_step(model, RCFG)(tiny_batch())
    tracing.count("refine.rows.enc0", 7)
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == []
    assert not tracing.enabled()


@pytest.mark.parametrize("info", [{}, TOME], ids=["base", "tome"])
def test_eval_and_train_steps_give_the_span_tree(info):
    merged = bool(info)
    batch = tiny_batch()
    eval_step = make_eval_step(tiny_model(info), RCFG)
    _, train_step = tiny_train_step(info)
    tracing.enable("cpu")
    t0 = time.time_ns()
    eval_step(batch)
    t1 = time.time_ns()
    train_step(batch, torch.Generator().manual_seed(0))
    t2 = time.time_ns()
    spans = tracing.snapshot()["spans"]
    assert tree_of(spans) == [
        ("eval_step", [refine_tree(merged), RENDER_TREE, ("score", [])]),
        ("train_step", [refine_tree(merged), RENDER_TREE, ("loss.l1", []),
                        ("loss.lpips", []), ("backward", []),
                        ("optimizer", [("optimizer.clip", []),
                                       ("optimizer.adam", [])])])]
    assert_nested(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert roots[0]["id"] != roots[1]["id"]
    assert {s["id"] for s in spans} == {roots[0]["id"], roots[1]["id"]}
    assert t0 <= roots[0]["start_ns"] and roots[0]["end_ns"] <= t1
    assert t1 <= roots[1]["start_ns"] and roots[1]["end_ns"] <= t2
    assert all(s["ms"] >= 0 for s in spans)
    # the fused projection covered both views of each render, once
    views = [(c["value"], c["id"]) for c in tracing.snapshot()["counters"]
             if c["name"] == "render.project.views"]
    assert views == [(2, roots[0]["id"]), (2, roots[1]["id"])]


def harness_stage_counts(model, monkeypatch, forward):
    """The benchmark harness's stage counts (perfbench/lib/base.py's hooks)
    of the forwards ``forward`` runs."""
    from perfbench.lib import program
    from perfbench.lib.base import Runner
    from perfbench.lib.spans import Spans
    # install_spans replaces these two module attributes; undo it after
    for mod, name in ((program.ptv3_module, "build_neighbor_map"),
                      (program.train_step_module, "render_images_stats")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    runner = Runner.__new__(Runner)
    runner.model, runner.spans, runner.counts = model, Spans("cpu"), []
    runner.install_spans()
    forward()
    runner.traced_counts = len(runner.counts)
    return runner.stages()


@pytest.mark.parametrize("info", [{}, TOME], ids=["base", "tome"])
def test_counters_equal_the_harness_and_the_diagnostics(info, monkeypatch):
    model = tiny_model(info).eval()
    scene = tiny_batch().scene
    diag = {}
    tracing.enable("cpu")

    def forward():
        with torch.inference_mode():
            model(scene, diagnostics=diag)
    [stages] = harness_stage_counts(model, monkeypatch, forward)
    got = {c["name"]: c["value"] for c in tracing.snapshot()["counters"]}
    n_enc = len(TINY_PTV3["enc_depths"])
    want_rows = {0: 256, 1: 256, 2: 192}
    for s in range(n_enc):
        assert got[f"refine.points.enc{s}"] == stages["points"][s] \
            == int(diag[f"enc{s}_n_valid"])
        assert got[f"refine.pairs.enc{s}"] == stages["pairs"][s]
        assert got[f"refine.rows.enc{s}"] == want_rows[s]
    for s in range(n_enc - 1):
        for kind in ("points", "pairs", "rows"):
            assert got[f"refine.{kind}.dec{s}"] == got[f"refine.{kind}.enc{s}"]
    assert len(got) == 3 * (2 * n_enc - 1)


def test_downsampling_has_its_span_and_the_picks_counter():
    """A traced CPU refine of a tiny ptv3_fps model: ``refine.downsample``
    opens first under ``refine``, and ``refine.fps.picks`` holds FPS's m
    (int(256 x 0.35) = 89) in the request's id; on the CPU the plain loop
    runs, so the FPS kernel's launch count stays put."""
    model = tiny_model({"downsample": "fps", "downsample_ratio": 0.35}).eval()
    scene = tiny_batch().scene
    before = LAUNCHES["fps"]
    tracing.enable("cpu")
    with torch.inference_mode():
        model(scene)
    snap = tracing.snapshot()
    [(name, kids)] = tree_of(snap["spans"])
    assert name == "refine" and kids[0] == ("refine.downsample", [])
    assert kids[1][0] == "refine.serialize"
    assert_nested(snap["spans"])
    picks = [(c["value"], c["id"]) for c in snap["counters"]
             if c["name"] == "refine.fps.picks"]
    assert picks == [(89, snap["spans"][0]["id"])]
    assert LAUNCHES["fps"] == before


@pytest.mark.parametrize("info", [{}, TOME], ids=["base", "tome"])
def test_outputs_are_bit_identical_with_tracing_on(info):
    batch = tiny_batch()
    eval_step = make_eval_step(tiny_model(info), RCFG)
    off = eval_step(batch)
    tracing.enable("cpu")
    on = eval_step(batch)
    tracing.disable()
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    runs = []
    for traced in (False, True):
        if traced:
            tracing.enable("cpu")
        model, step = tiny_train_step(info)
        metrics = step(batch, torch.Generator().manual_seed(0))
        runs.append((metrics["total_loss"],
                     [p.detach().clone() for p in model.parameters()]))
    (loss_off, params_off), (loss_on, params_on) = runs
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def sync_count(fn):
    """Synchronising CUDA calls that ``fn`` makes (the sync debug mode's
    warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.cuda
def test_tracing_adds_no_synchronisation_on_card():
    """The steps synchronise as often traced as untraced (the program's own
    synchronisations, such as a list index copied to the card, stay)."""
    _card()
    batch = tiny_batch("cuda")
    eval_step = make_eval_step(tiny_model({}, "cuda"), RCFG)
    _, train_step = tiny_train_step({}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def steps():
        eval_step(batch)
        train_step(batch, gen)
    steps()                              # the kernels' first load
    torch.cuda.synchronize()
    untraced = sync_count(steps)
    tracing.enable("cuda")
    assert sync_count(steps) == untraced
    names = {s["name"] for s in tracing.snapshot()["spans"]}
    assert {"eval_step", "train_step", "render.composite"} <= names


@pytest.mark.cuda
@pytest.mark.parametrize("views,hw", [(4, 256), (16, 512)])
def test_projection_does_not_synchronise_on_card(views, hw):
    """The body of ``render.project`` (the fused projection of every view)
    makes no synchronising call, at the serving cells' shapes, and counts
    its views once."""
    _card()
    from splatformer_tpu_torch.kernels.projection import project_views
    from splatformer_tpu_torch.ops.render import prepare_entries
    scene = random_scene(np.random.default_rng(0), 100_352, 1, 100_000)
    cams = orbit_cameras(views, hw, hw)
    project_views(scene, cams, RCFG)     # the kernel's first load
    torch.cuda.synchronize()
    assert sync_count(lambda: project_views(scene, cams, RCFG)) == 0
    tracing.enable("cuda")
    prepare_entries(scene, cams, RCFG)
    assert [c["value"] for c in tracing.snapshot()["counters"]
            if c["name"] == "render.project.views"] == [views]


@pytest.mark.cuda
def test_spans_share_the_profiler_trace_clock_on_card():
    """K1's launch (its runtime record's host time) falls inside its
    render.composite span, and K1 runs on the device after the span
    opened."""
    _card()
    batch = tiny_batch("cuda")
    eval_step = make_eval_step(tiny_model({}, "cuda"), RCFG)
    eval_step(batch)
    torch.cuda.synchronize()
    tracing.enable("cuda")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        eval_step(batch)
        torch.cuda.synchronize()
    [comp] = [s for s in tracing.snapshot()["spans"]
              if s["name"] == "render.composite"]
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if str(e.device_type()).endswith("CUDA")
               and "composite_fwd" in e.name()]
    assert len(kernels) == 1
    [k1] = kernels
    launches = [e for e in events if e.correlation_id() == k1.correlation_id()
                and not str(e.device_type()).endswith("CUDA")]
    assert launches, "no runtime record of K1's launch in the trace"
    assert comp["start_ns"] <= launches[0].start_ns() <= comp["end_ns"]
    assert k1.start_ns() >= comp["start_ns"]
