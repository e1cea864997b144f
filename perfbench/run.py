#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one CUDA device:

    python3 perfbench/run.py --workload serve_flash --seed 7 --seconds 45 \
        --trace 0

prints the result as the last line of standard output (JSON) and the
compared numbers beside their limits as the last lines of standard error.
Exits non-zero, with no result, without the CUDA devices the cell asks
for. perfbench/README.md says how to add a cell, a configuration or a
metric."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# a library that would load JAX by itself keeps from it
os.environ.setdefault("USE_FLAX", "0")

from perfbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
