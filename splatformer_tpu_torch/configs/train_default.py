"""Training schedule config (copy of splatformer_tpu/configs/train_default.py,
whose values mirror the reference's configs/train/default.gin), as plain
dataclasses: the train step's fields and the loop's (intervals, resume step,
pretrain steps, LPIPS weight and path, raster-budget calibration, the
finetune filter).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass
class OptimizerConfig:
    type: str = "adam"
    eps: float = 1e-15
    lr_dict: Dict[str, float] = field(default_factory=lambda: {
        "base": 3e-5, "backbone": 3e-5})
    schedule: str = "constant"
    warmup_steps: int = 0
    finetune_filter: Tuple[str, ...] = ()


@dataclass
class TrainConfig:
    seed: int = 42
    total_steps: int = 200_000
    pretrain_steps: int = 0
    eval_interval: int = 500
    log_interval: int = 20
    save_interval: int = 200_000
    log_image_interval: int = 2000
    grad_clip_norm: float = 2.0
    resume_from_step: int = 0
    image_l1_loss_weight: float = 1.0
    lpips_loss_weight: float = 1.0
    lpips_weights_path: str = "weights/lpips_vgg.npz"
    bf16: bool = True  # bfloat16 block compute in training
    # measure per-Gaussian tile statistics on the first batches and the
    # test set and size the binning budgets so num_dropped stays 0
    # (ops/calibrate.py)
    auto_raster_budget: bool = True
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


def get_config() -> TrainConfig:
    return TrainConfig()
