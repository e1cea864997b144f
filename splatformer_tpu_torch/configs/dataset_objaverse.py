"""Objaverse-OOD dataset config (copy of
splatformer_tpu/configs/dataset_objaverse.py, which mirrors the reference's
configs/dataset/objaverse.gin): splatfacto checkpoints and COLMAP folders
read by data/dataset.py:SplatfactoScenes.

The folders named here exist only outside the repository; the loader code
is tested on folders the data factory writes
(``python -m splatformer_tpu_torch.make_ood_benchmark``).
"""
from __future__ import annotations

from splatformer_tpu_torch.configs.scene_dataset import (
    SceneDatasetConfig, TestSplit, TrainSplit)


def get_config() -> SceneDatasetConfig:
    return SceneDatasetConfig(
        train=TrainSplit(
            nerfstudio_folder="train-set/objaverseOOD/nerfstudio",
            colmap_folder="train-set/objaverseOOD/colmap"),
        test=TestSplit(folders={
            "objaverse": ("test-set/objaverseOOD/nerfstudio",
                          "test-set/objaverseOOD/colmap"),
            "GSO": ("test-set/GSOOOD/nerfstudio", "test-set/GSOOOD/colmap"),
            "real": ("test-set/realOOD/nerfstudio",
                     "test-set/realOOD/colmap"),
        }))
