"""OOD refinement benchmark dataset (copy of
splatformer_tpu/configs/dataset_oodbench.py): scenes written by the data
factory (``python -m splatformer_tpu_torch.make_ood_benchmark``):
procedural ground truth, an input 3DGS fitted from low-elevation rings
only, OOD test views at elevations 70/80/90.

The objaverse config's shape at benchmark scale: poses from COLMAP (test
views are the images named test_*), 70% of the sampled training views
drawn from the OOD split.
"""
from __future__ import annotations

from splatformer_tpu_torch.configs.scene_dataset import (
    SceneDatasetConfig, TestSplit, TrainSplit)


def oodbench_splits(root: str, name: str):
    """(train split, test split) over ``root``/{train,test}/{nerfstudio,
    colmap}, the factory's layout; the test set is called ``name``."""
    train = TrainSplit(
        nerfstudio_folder=f"{root}/train/nerfstudio",
        colmap_folder=f"{root}/train/colmap",
        image_per_scene=4, sample_ratio_test=0.7, cache_steps=4,
        cache_num_scenes=4, split_across_processes=True,
        background_color=(0, 0, 0),
        # corruption-resampling augmentation: a fresh artifact draw per
        # sample keeps the few benchmark scenes from being memorised;
        # sigmas in normalised units (unit cube, log-scale, opacity logit)
        augment={"prob": 0.9, "noise_means": 0.003, "noise_scales": 0.12,
                 "noise_quats": 0.05, "noise_opacities": 0.3,
                 "floater_frac": 0.08, "floater_scale": 1.5})
    test = TestSplit(
        folders={name: (f"{root}/test/nerfstudio", f"{root}/test/colmap")},
        background_color=(0, 0, 0), split_across_processes=False)
    return train, test


def get_config() -> SceneDatasetConfig:
    train, test = oodbench_splits("data/oodbench", "oodbench")
    return SceneDatasetConfig(
        remove_outlier_ndevs=-1.0, max_gs_num=16384, pad_to=16384,
        load_pose_src="colmap", batch_size=1, accumulate_step=1,
        num_workers=2, train=train, test=test)
