"""Reference-scale tier of the OOD benchmark (copy of
splatformer_tpu/configs/dataset_oodbench_scale.py): 256^2 images and
65,536-slot scenes. Generate it with the flags of
scripts/run_oodbench_scale.sh:

    python -m splatformer_tpu_torch.make_ood_benchmark \\
        --out data/oodbench_scale --n_train_scenes 36 --n_test_scenes 8 \\
        --hw 256 --n_gauss 98304 --capacity 65536 --fit_steps 500 \\
        --seed_points 49152 --densify_budget_frac 0.08 --fit_warmup 100 \\
        --max_intersects 524288 --tiers 8,32768,24,4096
"""
from __future__ import annotations

from splatformer_tpu_torch.configs.dataset_oodbench import (
    get_config as _base, oodbench_splits)
from splatformer_tpu_torch.configs.scene_dataset import SceneDatasetConfig


def get_config() -> SceneDatasetConfig:
    cfg = _base()
    cfg.max_gs_num = 65536
    cfg.pad_to = 65536
    cfg.train, cfg.test = oodbench_splits("data/oodbench_scale",
                                          "oodbench_scale")
    return cfg
