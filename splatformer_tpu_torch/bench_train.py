"""Train-step throughput of the port on one card (the repo-root
bench_train.py): bench.py's train step alone, one JSON line.

    python -m splatformer_tpu_torch.bench_train [n [hw]] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from splatformer_tpu_torch.bench import bench_train_step, device_info, log


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=100_000)
    p.add_argument("hw", type=int, nargs="?", default=256)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench_train: no CUDA device is available (pass --cpu to run "
              "on the CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda:0")
    iters_s, dt, peak, metrics = bench_train_step(args.n, args.hw, device)
    log(f"train step: {dt * 1e3:.1f} ms {metrics}")
    print(json.dumps({
        "metric": "train_step_iters_per_s_per_chip",
        "value": round(iters_s, 3),
        "unit": "iters/s",
        "vs_baseline": 1.0,
        "extra": {"measured_ms": dt * 1e3, "peak_mem_gb": peak,
                  "config": {"n": args.n, "hw": args.hw, "views": 4,
                             "model": "ptv3_base bf16"},
                  "device": device_info(device)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
