"""The eval step (port of make_eval_step of
splatformer_tpu/training/train_step.py): refine one scene with the
FeaturePredictor, render its views, score them. One scene per call on one
device; the JAX package's shard_map over a device mesh has no counterpart
here. The train step belongs to the training slice (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor
from splatformer_tpu_torch.ops.render import render_images_stats
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)
from splatformer_tpu_torch.training.metrics import psnr, ssim


@dataclass
class SceneBatch:
    """One request: a scene, its views and their ground truth."""

    scene: GaussianScene
    cameras: Camera          # c2w (V, 3, 4), intrinsics (V,)
    images: torch.Tensor     # (V, H, W, 3) ground truth in [0, 1]
    background: torch.Tensor  # (3,)


EvalOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor]


def make_eval_step(model: Optional[FeaturePredictor],
                   raster_config: RasterizeConfig = RasterizeConfig(),
                   render_input: bool = False
                   ) -> Callable[[SceneBatch], EvalOutput]:
    """Returns eval(batch) -> (rgb (V, H, W, 3), alpha (V, H, W, 1),
    per-view psnr (V,), per-view ssim (V,), num_dropped ()), computed on the
    batch's device. ``render_input`` scores the unrefined scene."""
    if not render_input:
        model.eval()

    @torch.inference_mode()
    def eval_step(batch: SceneBatch) -> EvalOutput:
        refined = batch.scene if render_input else model(batch.scene)
        rgb, alpha, rstats = render_images_stats(
            refined, batch.cameras, batch.background, raster_config)
        return (rgb, alpha, psnr(rgb, batch.images),
                ssim(rgb, batch.images), rstats["num_dropped"])

    return eval_step
