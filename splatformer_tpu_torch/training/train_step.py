"""The train and eval steps (port of splatformer_tpu/training/train_step.py).

Train: refine one scene with the FeaturePredictor in train mode, render
its views (the compositing backward is the K2 kernel), L1 (+ LPIPS) loss,
backward, one optimizer step. Eval: refine, render, score. One scene per
call and process. With a ``mesh`` (parallel/mesh.py) the train step is the
JAX package's data-parallel step: after the backward the gradients and the
metrics are averaged over the mesh's data group (its ``pmean``, as one
all-reduce of a flat buffer), then the optimizer (clip, Adam) steps on the
average. Each process scores its own scenes in evaluation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor
from splatformer_tpu_torch.models.lpips import LPIPS
from splatformer_tpu_torch.ops.render import render_images_stats
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)
from splatformer_tpu_torch.parallel.collectives import (all_reduce_mean_,
                                                        scalars_mean)
from splatformer_tpu_torch.training.metrics import psnr, ssim
from splatformer_tpu_torch.training.optim import ChainOptimizer


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
        with tracing.span("eval_step"):
            refined = batch.scene if render_input else model(batch.scene)
            rgb, alpha, rstats = render_images_stats(
                refined, batch.cameras, batch.background, raster_config)
            with tracing.span("score"):
                scores = psnr(rgb, batch.images), ssim(rgb, batch.images)
        return (rgb, alpha, *scores, rstats["num_dropped"])

    return eval_step


PRETRAIN_ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
                  "features_rest")


def trainable_grads(model: torch.nn.Module) -> List[torch.Tensor]:
    """Every trainable parameter's gradient, zeros where the backward left
    none (the optimizer reads a missing gradient as zeros too), so that
    every process reduces the same tensors."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def reduce_gradients(model: torch.nn.Module, group) -> None:
    """``pmean`` of the gradients over ``group``, in place: one flat buffer
    per dtype, one SUM, one division by the group's size."""
    if group is not None:
        all_reduce_mean_(trainable_grads(model), group)


def make_train_step(model: FeaturePredictor, optimizer: ChainOptimizer,
                    raster_config: RasterizeConfig = RasterizeConfig(),
                    image_l1_loss_weight: float = 1.0,
                    lpips_loss_weight: float = 0.0,
                    lpips: Optional[LPIPS] = None,
                    pretrain: bool = False,
                    pretrain_attrs: Sequence[str] = PRETRAIN_ATTRS,
                    mesh=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, generator=None, order_perm=None,
    merge_scores=None, downsample_scores=None) -> metrics.

    The generator (on the batch's device) drives DropPath, the order
    shuffle, random_patch merging and random downsampling; ``order_perm``,
    ``merge_scores`` and ``downsample_scores`` fix those draws instead
    (FeaturePredictor.forward). Metrics, as 0-d tensors:
    ``total_loss``; with rendering ``image_l1``, ``train_psnr``,
    ``num_dropped`` and, when LPIPS is on, ``lpips``; with ``pretrain``
    (per-attribute L1 of the refined against the input attributes over
    valid points, no rendering) ``pretrain_loss`` and ``pretrain/<attr>``.
    LPIPS is on when its weight is positive and a model is given; its
    parameters are frozen. With ``mesh`` the gradients and the metrics are
    averaged over ``mesh.data_group`` before the optimizer steps (build the
    model with ``bn_group=mesh.data_group`` for the JAX package's synced
    BatchNorm)."""
    use_lpips = lpips is not None and lpips_loss_weight > 0
    if use_lpips:
        lpips.requires_grad_(False)

    def step(batch: SceneBatch, generator: Optional[torch.Generator] = None,
             order_perm: Optional[torch.Tensor] = None,
             merge_scores: Optional[Iterable[torch.Tensor]] = None,
             downsample_scores: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        with tracing.span("train_step"):
            return _step(batch, generator, order_perm, merge_scores,
                         downsample_scores)

    def _step(batch, generator, order_perm, merge_scores, downsample_scores):
        model.train()
        optimizer.zero_grad()
        refined = model(batch.scene, generator, order_perm, merge_scores,
                        downsample_scores)
        metrics = {}
        if pretrain:
            mask = batch.scene.valid_mask()
            denom = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
            loss = 0.0
            for key in pretrain_attrs:
                target = getattr(batch.scene, key).detach()
                pred = getattr(refined, key)
                m = mask.reshape((-1,) + (1,) * (pred.ndim - 1))
                width = float(math.prod(pred.shape[1:]))
                per_attr = (torch.sum(torch.abs(pred - target) * m)
                            / (denom * width))
                metrics[f"pretrain/{key}"] = per_attr.detach()
                loss = loss + per_attr
            metrics["pretrain_loss"] = loss.detach()
        else:
            rgb, _, rstats = render_images_stats(
                refined, batch.cameras, batch.background, raster_config)
            with tracing.span("loss.l1"):
                l1 = torch.mean(torch.abs(rgb - batch.images))
                metrics["num_dropped"] = rstats["num_dropped"].to(
                    torch.float32)
                loss = image_l1_loss_weight * l1
                metrics["image_l1"] = l1.detach()
                metrics["train_psnr"] = torch.mean(psnr(rgb.detach(),
                                                        batch.images))
            if use_lpips:
                with tracing.span("loss.lpips"):
                    lp = torch.mean(lpips(rgb, batch.images))
                    loss = loss + lpips_loss_weight * lp
                    metrics["lpips"] = lp.detach()
        metrics["total_loss"] = loss.detach()
        with tracing.span("backward"):
            loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh.data_group)
            metrics = scalars_mean(metrics, mesh.data_group)
        with tracing.span("optimizer"):
            optimizer.step()
        return metrics

    return step
