"""Multi-process utilities (port of splatformer_tpu/parallel/distributed.py):
initialisation under torchrun, barriers, the cross-process metric
reduction (the reference's dist.init_process_group / dist.barrier /
dist.reduce)."""
from __future__ import annotations

import datetime
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def process_rank() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def maybe_initialize_distributed(device: torch.device,
                                 timeout: datetime.timedelta = TIMEOUT
                                 ) -> Tuple[int, int]:
    """Join the process group that torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` in the
    environment): NCCL on the card, after selecting the card ``LOCAL_RANK``,
    gloo on the CPU. Without ``WORLD_SIZE``, or when a group exists
    already, nothing is done. Returns (rank, world size)."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", timeout=timeout)
    return process_rank()


def sync_processes(name: str = "barrier") -> None:
    """A barrier across every process (dist.barrier); a no-op in one
    process. ``name`` says which barrier, for the reader of a hang."""
    del name
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def reduce_metric_sums(sums: Dict[str, float], count: float
                       ) -> Dict[str, float]:
    """Sum per-process metric totals and image counts across processes and
    return the global per-image means (train.py:170-191: reduce the sums
    and the counts, divide on the host). One float64 all-reduce."""
    keys = sorted(sums)
    local = np.asarray([sums[k] for k in keys] + [count], np.float64)
    if dist.is_available() and dist.is_initialized():
        t = torch.from_numpy(local)
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        local = t.cpu().numpy()
    n = max(float(local[-1]), 1.0)
    return {k: float(local[i] / n) for i, k in enumerate(keys)}
