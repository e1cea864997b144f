"""ShapeNet-OOD dataset config (copy of
splatformer_tpu/configs/dataset_shapenet.py, the reference's
configs/dataset/shapenet.gin): objaverse's, on the ShapeNet folders."""
from __future__ import annotations

from splatformer_tpu_torch.configs.dataset_objaverse import get_config as _base
from splatformer_tpu_torch.configs.scene_dataset import SceneDatasetConfig


def get_config() -> SceneDatasetConfig:
    cfg = _base()
    cfg.train.nerfstudio_folder = "train-set/shapenetOOD/nerfstudio"
    cfg.train.colmap_folder = "train-set/shapenetOOD/colmap"
    cfg.test.folders = {
        "shapenet": ("test-set/shapenetOOD/nerfstudio",
                     "test-set/shapenetOOD/colmap"),
    }
    return cfg
