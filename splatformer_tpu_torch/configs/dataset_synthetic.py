"""Synthetic in-memory dataset config (copy of
splatformer_tpu/configs/dataset_synthetic.py): smoke runs and benchmarks
without the external, multi-GB scene datasets. Scenes come from
data/synthetic.py."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class DatasetConfig:
    synthetic: bool = True
    n_scenes: int = 8
    n_gaussians: int = 4096
    pad_to: int = 4096
    max_gs_num: int = 4096
    image_size: int = 64
    image_per_scene: int = 2
    batch_size: int = 1
    accumulate_step: int = 1
    background_color: Tuple[int, int, int] = (0, 0, 0)
    # host-side prefetch depth, read by the loop (the JAX package's
    # ``cfg.dataset.get("num_workers", 0)``): above 0 a host thread loads
    # that many batches ahead of the step (training/loop.py), as for every
    # dataset
    num_workers: int = 0


def get_config() -> DatasetConfig:
    return DatasetConfig()
