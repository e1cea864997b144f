"""BENCHMARK.json against the contract's shape and the files the harness
finds by name; a new cell and a new metric found from added files alone;
run.py's refusals (no card, no program) and its module check."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_load_by_name(workload):
    cell = harness.load_cell(BENCH, workload)
    assert cell["traffic"]["kind"] in ("serve", "train")
    assert cell["limits"], "every cell has the limits of its comparison"
    assert cell["workload"]["chips"] == 1
    for traced in (False, True):
        metrics = harness.metrics_for(BENCH, workload, traced)
        assert metrics
        for m in metrics:
            assert callable(harness.reader(m["name"]))
    e2e = {m["name"] for m in harness.metrics_for(BENCH, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2


def test_each_config_is_used_and_its_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert "workloads" not in moved or w in moved["workloads"]


def test_a_new_cell_and_metric_are_found_from_added_files(tmp_path):
    """A later PR adds a traffic file, a limits file, a metric reader and
    entries in BENCHMARK.json; no file that is there changes."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    traffic = json.loads((tmp_path / "perfbench/traffic/serve_4x256.json")
                         .read_text())
    traffic.update(views=2, height=128, width=128)
    (tmp_path / "perfbench/traffic/serve_2x128.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench/limits/serve_small.json").write_text(
        json.dumps({"limits": {"refine_gap": 3e-4}}))
    (tmp_path / "perfbench/metrics/host_copy_ms.serve.py").write_text(
        "def read(run):\n    return 1.5\n")
    bench["workloads"].append({"name": "serve_small",
                               "config": "ptv3_base_flash",
                               "traffic": "serve_2x128", "chips": 1,
                               "why": "a smaller request"})
    bench["per_layer"].append({"name": "host_copy_ms.serve", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "eval step", "moves": "scenes_per_s",
                               "workloads": ["serve_small"]})
    cell = harness.load_cell(bench, "serve_small", root=tmp_path)
    assert cell["traffic"]["views"] == 2 and cell["limits"]
    names = [m["name"] for m in harness.metrics_for(bench, "serve_small",
                                                    True)]
    assert names == ["host_copy_ms.serve"]
    assert harness.reader("host_copy_ms.serve", root=tmp_path)(None) == 1.5
    for p, data in before.items():
        assert p.read_bytes() == data, p


def run_py(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "serve_flash",
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = run_py(ROOT)
    assert r.returncode != 0
    assert "needs 1 CUDA device" in r.stderr
    assert not r.stdout.strip()


def test_run_exits_nonzero_without_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = run_py(tmp_path)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "splatformer_tpu_torch" in r.stderr


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench.lib import harness, program, serve, train;"
            "from perfbench import control;"
            "print(harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
