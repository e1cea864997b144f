"""512^2 tier of the OOD benchmark (copy of
splatformer_tpu/configs/dataset_oodbench_512.py): 65,536-slot scenes
rendered and evaluated at 512^2 (make_ood_benchmark ``--hw 512``)."""
from __future__ import annotations

from splatformer_tpu_torch.configs.dataset_oodbench import (
    get_config as _base, oodbench_splits)
from splatformer_tpu_torch.configs.scene_dataset import SceneDatasetConfig


def get_config() -> SceneDatasetConfig:
    cfg = _base()
    cfg.max_gs_num = 65536
    cfg.pad_to = 65536
    cfg.train, cfg.test = oodbench_splits("data/oodbench_512",
                                          "oodbench_512")
    return cfg
