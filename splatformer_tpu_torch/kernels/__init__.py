"""Hand-written CUDA kernels and their wrappers.

Every wrapper takes its kernel's plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. Each wrapper adds one to
its entry in ``LAUNCHES`` where it launches its kernel, and nowhere else, so
a run can show that its main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0, "attention_fwd": 0,
            "attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
