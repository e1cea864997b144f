"""The shape of every scene-folder dataset config (objaverse, shapenet,
oodbench and its tiers), as dataclasses: splatfacto checkpoints and COLMAP
folders read by data/dataset.py:SplatfactoScenes. Each dataset's module
fills in its folders and settings."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple, Union

Color = Union[str, Tuple[int, int, int]]


@dataclass
class TrainSplit:
    nerfstudio_folder: str = ""
    colmap_folder: str = ""
    image_per_scene: int = 4
    sample_ratio_test: float = 0.7
    cache_steps: int = 1
    cache_num_scenes: int = 1
    split_across_processes: bool = True
    background_color: Color = "random"
    # corruption-resampling augmentation (data/dataset.py:
    # corrupt_gaussians); empty = off, as the JAX loop reads a missing one
    augment: Dict[str, float] = field(default_factory=dict)


@dataclass
class TestSplit:
    # name -> (nerfstudio folder, colmap folder)
    folders: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    background_color: Color = (0, 0, 0)
    split_across_processes: bool = False


@dataclass
class SceneDatasetConfig:
    remove_outlier_ndevs: float = -1.0
    max_gs_num: int = 100_000
    pad_to: int = 0  # 0 -> round max_gs_num up to a multiple of 1024
    load_pose_src: str = "nerfstudio"
    batch_size: int = 1          # scenes a micro-step
    accumulate_step: int = 1
    num_workers: int = 4
    train: TrainSplit = field(default_factory=TrainSplit)
    test: TestSplit = field(default_factory=TestSplit)
