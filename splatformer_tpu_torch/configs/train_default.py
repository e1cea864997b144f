"""Training schedule config: the fields of splatformer_tpu/configs/train_default.py
(whose values mirror the reference's configs/train/default.gin) that the
port's train step reads, as plain dataclasses.

The loop's intervals, resume step, pretrain steps, LPIPS weight and path,
the finetune filter and the raster-budget calibration switch come with the
training loop and ops/calibrate.py (queued in ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class OptimizerConfig:
    type: str = "adam"
    eps: float = 1e-15
    lr_dict: Dict[str, float] = field(default_factory=lambda: {
        "base": 3e-5, "backbone": 3e-5})
    schedule: str = "constant"
    warmup_steps: int = 0


@dataclass
class TrainConfig:
    seed: int = 42
    total_steps: int = 200_000
    grad_clip_norm: float = 2.0
    image_l1_loss_weight: float = 1.0
    bf16: bool = True  # bfloat16 block compute in training
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


def get_config() -> TrainConfig:
    return TrainConfig()
