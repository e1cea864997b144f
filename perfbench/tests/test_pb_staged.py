"""The comparison of a downsampling configuration, stage by stage, at the
tiny size on the CPU: the program's reduced set against the reference's,
then the reference's backbone, heads and map back on the program's reduced
set. One ulp of a cluster mean across a grid cell's edge, as the card's
atomic sums give now and then, fails the end-to-end comparison and passes
this one; a changed pick or a moved mean fails it; the cells without
downsampling read what the end-to-end comparison reads."""
from __future__ import annotations

import pytest
import torch

from perfbench.lib import compare, faults, program, weights
from perfbench.lib.serve import Serve
from perfbench.reference import downsample as ref_ds
from perfbench.reference import steps as reference
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242
GRID = 384  # the configuration's grid_resolution


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _up(x: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(x, torch.tensor(float("inf")))


def _down(x: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(x, torch.tensor(float("-inf")))


def cell_edge(k: int) -> torch.Tensor:
    """The least float32 in grid cell ``k`` (floor(v * GRID), as the point
    batch takes it): one ulp below it lies in cell k - 1."""
    b = torch.tensor(k / GRID, dtype=torch.float32)
    while torch.floor(b * GRID) < k:
        b = _up(b)
    while torch.floor(_down(b) * GRID) >= k:
        b = _down(b)
    return b


# cells 255 and 256 lie in different halves of the space-filling curves, so
# a point that crosses this edge moves far in every serialization order (at
# the tiny size points lie apart: a step to the next cell elsewhere moves
# nothing; at full size, on dense surfaces, any edge can)
EDGE = 256


def put_a_singleton_on_an_edge(noisy, ratio: float) -> torch.Tensor:
    """Move the x of a live point to the lower edge of cell EDGE, where
    FPS makes it a centroid whose cluster holds it alone, so that its
    cluster mean (the point itself) lies one ulp above the cell before;
    return that x."""
    coord, mask = noisy["means"], noisy["mask"]
    feat = torch.zeros(coord.shape[0], 1)
    edge = cell_edge(EDGE)
    for j in torch.nonzero(mask).flatten().tolist():
        moved = coord.clone()
        moved[j, 0] = edge
        ds, _, dm, assign = ref_ds.fps_knn_downsample(moved, feat, mask,
                                                      ratio)
        row = assign[j]
        if bool(dm[row]) and int((assign == row).sum()) == 1:
            coord.copy_(moved)
            return edge
    raise AssertionError("no point is a cluster of its own on the edge")


def nudged_across_an_edge(d) -> None:
    """Each pool scene holds a cluster mean on a grid cell's edge, and the
    program's cluster means put it one ulp below: one reduced point in the
    cell before, as the card's atomic sums may."""
    ratio = float(d.cfg["model"]["additional_info"]["downsample_ratio"])
    edges = torch.stack([put_a_singleton_on_an_edge(p["noisy"], ratio)
                         for p in d.pool])

    def wrap(means):
        def nudged(coord, feat, mask, assign, m):
            ds_coord, ds_feat, cnt = means(coord, feat, mask, assign, m)
            x = ds_coord[:, 0]
            on_edge = torch.isin(x, edges) & (cnt == 1)
            ds_coord = ds_coord.clone()
            ds_coord[:, 0] = torch.where(on_edge, _down(x), x)
            return ds_coord, ds_feat, cnt
        return nudged
    faults._patch_downsampling(d, "_cluster_means", wrap)


def kept_run(cell, plant=None) -> Serve:
    d = Serve(cell, SEED, "cpu", False)
    d.plant = plant
    d.setup()
    d.window(0.5)
    d.free()
    return d


def end_to_end_refine_gap(d: Serve) -> float:
    """The refine_gap of the comparison before it was staged: the
    reference's refine with its own downsampling."""
    ref = reference.build_model(d.cfg["model"], d.device)
    weights.load(ref, d.model_state(ref))
    return max(compare.refine_gap(refined, reference.refine(
                   ref, d.pool[pi]["noisy"]), d.pool[pi]["noisy"])
               for _, pi, _, refined, _ in d.kept)


def test_an_ulp_across_a_grid_edge_fails_only_end_to_end():
    cell = tiny_cell("serve_fps")
    d = kept_run(cell, nudged_across_an_edge)
    try:
        staged = d.numbers()
        e2e = end_to_end_refine_gap(d)
    finally:
        d.restore()
    limits = cell["limits"]
    assert e2e > limits["refine_gap"]
    assert 0 < staged["reduced_gap"] <= limits["reduced_gap"]
    assert compare.passed(compare.verdict(staged, limits)), staged


@pytest.mark.parametrize("fault,fails", [
    ("fps_pick_moved", "assign_mismatch"),
    ("cluster_mean_moved", "reduced_gap")])
def test_a_fault_of_the_downsampling_fails_its_number(fault, fails):
    cell = tiny_cell("serve_fps")
    d = kept_run(cell, faults.faults_for(cell)[fault])
    try:
        found = d.numbers()
    finally:
        d.restore()
    assert found[fails] > cell["limits"][fails], found


def test_the_reduced_set_is_the_programs_and_the_refine_follows_it():
    """On the CPU the reference's reduced set is the program's bit for bit,
    and its refine on the program's set is its refine on its own."""
    cell = tiny_cell("serve_fps")
    d = kept_run(cell)
    ref = reference.build_model(cell["config"]["model"], "cpu")
    weights.load(ref, d.model_state(ref))
    assert d.kept
    for _, pi, _, _, reduced in d.kept:
        noisy = d.pool[pi]["noisy"]
        want = reference.reduce(ref, noisy)
        assert all(torch.equal(g, w) for g, w in zip(reduced, want))
        own, followed = (reference.refine(ref, noisy),
                         reference.refine(ref, noisy, reduced=reduced))
        assert all(torch.equal(own[k], followed[k]) for k in own)
    assert compare.reduced_numbers(reduced, want) == {
        "assign_mismatch": 0.0, "reduced_gap": 0.0}


@pytest.mark.parametrize("workload", ["serve_flash", "serve_tome"])
@pytest.mark.parametrize("lower", [None, "tf32"])
def test_a_cell_without_downsampling_reads_the_end_to_end_numbers(workload,
                                                                  lower):
    """Without downsampling the numbers are the end-to-end comparison's:
    the reference's refine of the input, and its render and scores of the
    program's (or the control's) refined scene; nothing is recorded."""
    cell = tiny_cell(workload)
    d = kept_run(cell)
    assert all(reduced is None for *_, reduced in d.kept)
    assert program.downsample_module.fps_knn_downsample.__name__ == \
        "fps_knn_downsample"
    got = d.numbers(lower)
    ref = reference.build_model(cell["config"]["model"], "cpu")
    weights.load(ref, d.model_state(ref))
    want = {}
    for _, pi, host, refined, _ in d.kept:
        p = d.pool[pi]
        want_refined = reference.refine(ref, p["noisy"])
        if lower:
            refined = reference.refine(ref, p["noisy"], lower)
            host = reference.render_and_score(
                refined, p["noisy"]["mask"], p["clean"], d.cams, d.bgs[pi],
                lower)
        found = compare.image_numbers(host, reference.render_and_score(
            refined, p["noisy"]["mask"], p["clean"], d.cams, d.bgs[pi]))
        found["refine_gap"] = compare.refine_gap(refined, want_refined,
                                                 p["noisy"])
        for k, v in found.items():
            want[k] = max(want.get(k, 0.0), v)
    want["dropped"] = float(d.dropped)
    assert got == want
