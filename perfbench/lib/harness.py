"""Runs one cell of BENCHMARK.json once and prints the result line.

Everything a cell needs is found by name: its configuration file (the
``file`` of its entry under ``configs``), its traffic mix
(``perfbench/traffic/<traffic>.json``), the limits of its comparison
(``perfbench/limits/<workload>.json``) and one reader a metric
(``perfbench/metrics/<metric>.py``, a ``read(run)`` that returns the value
or None when the run holds nothing to read)."""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
# top-level modules that must not be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "splatformer_tpu")


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """{workload, config, traffic, limits, metrics} of one cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / "perfbench"
    limits_file = bench_dir / "limits" / f"{workload}.json"
    return {
        "workload": w,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": (json.loads(limits_file.read_text())["limits"]
                   if limits_file.exists() else {}),
    }


def metrics_for(bench: Dict, workload: str, traced: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``traced`` False) or per-layer
    metrics (True)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, peak: int) -> Dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run(cell: Dict, metrics: List[Dict], seed: int, seconds: float,
        traced: bool, device, t_start: float,
        plant: Optional[Callable] = None) -> Dict:
    """One run of a cell: set-up, the window, the comparison. ``plant``
    (tests only) plants a fault of lib/faults.py in the timed path."""
    import torch
    from perfbench.lib import compare
    from perfbench.lib.serve import Serve
    from perfbench.lib.train import Train

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kind = cell["traffic"]["kind"]
    runner = {"serve": Serve, "train": Train}[kind](cell, seed, device,
                                                    traced)
    runner.plant = plant
    runner.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    runner.window(seconds)
    measured = runner.measured()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    runner.free()
    t_check = time.perf_counter()
    numbers = runner.numbers()
    if runner.restore is not None:
        runner.restore()
    print(f"perfbench: setup {setup_s:.1f} s, window and trace "
          f"{t_check - t_window:.1f} s, reference "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    checks = compare.verdict(numbers, cell["limits"])
    rec = SimpleNamespace(setup_s=setup_s, peak_bytes=peak, cell=cell,
                          **measured)
    values = {}
    for m in metrics:
        v = reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = measured["done"]
    failed = measured["failed"]
    out = {"correct": compare.passed(checks) and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": values,
           "device": device_info(device, peak)}
    if traced:
        from perfbench.lib import trace
        t = measured["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = trace.breakdown(t)
    times = measured.get("latencies_s") or measured.get("step_s") or [0.0]
    out["times_ms"] = {"median": statistics.median(times) * 1e3,
                       "mean": statistics.fmean(times) * 1e3,
                       "max": max(times) * 1e3,
                       "slowest_at": sorted(range(len(times)),
                                            key=lambda i: -times[i])[:5]}
    out["numbers"] = numbers
    out["checks"] = checks
    return out


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    bench = load_benchmark()
    cell = load_cell(bench, args.workload)
    # the program under test; without it there is nothing to run
    from perfbench.lib import program  # noqa: F401
    import torch
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: the cell needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    metrics = metrics_for(bench, args.workload, bool(args.trace))
    # one process with one intra-op thread: the host's other cores stay
    # free, and no idle worker spins beside the thread that launches
    torch.set_num_threads(1)
    out = run(cell, metrics, args.seed, args.seconds, bool(args.trace),
              "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(out), allow_nan=False))
    return 0


def finite(obj):
    """``obj`` with every non-finite float as None (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
