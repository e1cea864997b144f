#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell
on one CUDA device, in one process:

    python3 perfbench/control.py --workload serve_flash --seeds 1 2 3 \
        [--seconds 3]

For each seed: set up the cell as a run does, run a short window at the
cell's own load, then print one JSON line with the compared numbers of the
program against the reference (the lower reading) and of the control (the
reference in the precision below the configuration's, in the program's
place) against the reference (the upper reading); with ``--faults``, the
numbers of runs with a fault of lib/faults.py planted (those of the cell's
kind and, where the configuration downsamples its input, those of the
downsampling's stage). Serving cells take TF32 products and bfloat16
render entries as the control; training cells the precision below the
recipe's blocks: float8 (e4m3, scaled) products inside bfloat16 blocks, or
bfloat16 blocks where the recipe keeps them float32."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.lib import harness  # noqa: E402


def control_mode(cell) -> str:
    """The control's precision for a cell (precision.py's modes, and
    ``bf16`` for bfloat16 blocks)."""
    tr = cell["traffic"]
    if tr["kind"] == "serve":
        return "tf32"
    return "fp8" if tr["recipe"]["bf16"] else "bf16"


def planted(cell, seed: int, seconds: float, device, name: str) -> dict:
    """The compared numbers of a run with one fault of lib/faults.py."""
    from perfbench.lib.faults import faults_for
    d = runner(cell, seed, device)
    d.plant = faults_for(cell)[name]
    d.setup()
    d.window(seconds)
    d.free()
    try:
        return {"seed": seed, "fault": name, "numbers": d.numbers()}
    finally:
        if d.restore is not None:
            d.restore()


def runner(cell, seed: int, device):
    from perfbench.lib.serve import Serve
    from perfbench.lib.train import Train
    kind = cell["traffic"]["kind"]
    return {"serve": Serve, "train": Train}[kind](cell, seed, device, False)


def readings(cell, seed: int, seconds: float, device) -> dict:
    import torch
    mode = control_mode(cell)
    d = runner(cell, seed, device)
    t0 = time.perf_counter()
    d.setup()
    d.window(seconds)
    d.free()
    t1 = time.perf_counter()
    program = d.numbers()
    t2 = time.perf_counter()
    control = d.numbers(lower=mode)
    t3 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "program": program, "control": control,
            "control_mode": mode, "setup_and_window_s": t1 - t0,
            "reference_s": t2 - t1, "control_s": t3 - t2}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", nargs="*", default=None,
                   help="instead of the control, plant these faults of "
                   "lib/faults.py (all the cell can have if none named)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(harness.load_benchmark(), args.workload)
    for seed in args.seeds:
        if args.faults is None:
            print(json.dumps(readings(cell, seed, args.seconds, "cuda")),
                  flush=True)
            continue
        from perfbench.lib.faults import faults_for
        for name in args.faults or faults_for(cell):
            print(json.dumps(planted(cell, seed, args.seconds, "cuda",
                                     name)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
