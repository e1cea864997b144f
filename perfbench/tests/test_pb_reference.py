"""The comparison that decides ``correct``, driven through the harness at
the tiny size on the CPU (the port's plain paths in place of its kernels):
a sound run is correct; each fault the cell can have, planted in the timed
path, and the control, the reference in the precision below the
configuration's in the program's place, are not."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import control
from perfbench.lib import compare, harness
from perfbench.lib.faults import faults_for
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def run(workload, plant=None):
    cell = tiny_cell(workload)
    metrics = harness.metrics_for(harness.load_benchmark(), workload, False)
    return harness.run(cell, metrics, SEED, 0.5, False, "cpu",
                       time.perf_counter(), plant=plant)


@pytest.mark.parametrize("workload", ["serve_flash", "serve_tome",
                                      "serve_fps", "train_flash",
                                      "train_flash_f32"])
def test_a_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(tiny_cell(workload)["limits"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("serve_flash", "serve_fps", "train_flash",
                     "train_flash_f32")
    for f in faults_for(tiny_cell(w))])
def test_a_planted_fault_is_not_correct(workload, fault):
    out = run(workload, faults_for(tiny_cell(workload))[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,mode,fails", [
    ("serve_flash", "tf32", ()), ("serve_fps", "tf32", ("refine_gap",)),
    ("train_flash", "fp8", ()),
    ("train_flash_f32", "bf16", ("refine1_rms_gap", "grad_gap"))])
def test_the_control_is_not_correct(workload, mode, fails):
    """The reference in TF32 (serving), float8 products in bfloat16 blocks
    (a bfloat16 recipe) or bfloat16 blocks (a float32 recipe) in the
    program's place fails the cell's limits, and each number in ``fails``
    (those it fails on every seed on the card)."""
    cell = tiny_cell(workload)
    r = control.readings(cell, SEED, 0.5, "cpu")
    assert r["control_mode"] == mode
    assert compare.passed(compare.verdict(r["program"], cell["limits"]))
    assert not compare.passed(compare.verdict(r["control"], cell["limits"]))
    for name in fails:
        assert r["control"][name] > cell["limits"][name], name
