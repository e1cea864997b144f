"""Everything the harness takes from the program, splatformer_tpu_torch:
its model, its eval and train steps, its optimizer and LPIPS modules, its
render (for the ground truth and the raster calibration), its launch
counters, its tracer (its own spans and counters, read in traced runs) and
the reduced sets its input downsampling makes (which the comparison checks
and then follows, stage by stage). No other harness file imports the
program."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.configs.model_ptv3_base import (BackboneConfig,
                                                           ModelConfig)
from splatformer_tpu_torch.kernels import LAUNCHES
from splatformer_tpu_torch.models import ptv3 as ptv3_module
from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor
from splatformer_tpu_torch.models.lpips import LPIPS
from splatformer_tpu_torch.ops import downsample as downsample_module
from splatformer_tpu_torch.ops.calibrate import calibrate_raster_config
from splatformer_tpu_torch.ops.render import render_images_stats
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)
from splatformer_tpu_torch.training import train_step as train_step_module
from splatformer_tpu_torch.training.optim import build_optimizer
from splatformer_tpu_torch.training.train_step import (SceneBatch,
                                                       make_eval_step,
                                                       make_train_step)

__all__ = ["LAUNCHES", "LPIPS", "SceneBatch", "build_model", "build_optimizer",
           "calibrate", "camera", "downsample_module", "make_eval_step",
           "make_train_step", "ptv3_module", "record_downsampling", "render",
           "scene", "tracing", "train_step_module"]


def model_config(model: Dict[str, Any]) -> ModelConfig:
    """The port's ModelConfig from a configuration file's ``model``."""
    fields = dict(model)
    bb = {k: tuple(v) if isinstance(v, list) else v
          for k, v in fields.pop("backbone").items()}
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in fields.items()}
    return dataclasses.replace(ModelConfig(), backbone=BackboneConfig(**bb),
                               **fields)


def build_model(model: Dict[str, Any], device,
                compute_dtype: Optional[torch.dtype] = None
                ) -> FeaturePredictor:
    """The port's FeaturePredictor, made on ``device`` with torch's default
    initialisation (the harness loads its own weights over it), in eval
    mode; the keyword mapping of build_feature_predictor."""
    cfg = model_config(model)
    with torch.device(device):
        net = FeaturePredictor(
            backbone_type=cfg.backbone_type, sh_degree=cfg.sh_degree,
            input_features=cfg.input_features,
            output_features=cfg.output_features,
            input_feat_to_mlp=cfg.input_feat_to_mlp,
            output_head_nlayer=cfg.output_head_nlayer,
            output_head_width=cfg.output_head_width,
            output_features_type=cfg.output_features_type,
            res_feature_activation=dict(cfg.res_feature_activation),
            max_scale_normalized=cfg.max_scale_normalized,
            grid_resolution=cfg.grid_resolution,
            backbone_kwargs=cfg.backbone.backbone_kwargs(),
            compute_dtype=compute_dtype,
            additional_info=cfg.additional_info)
    return net.eval()


def scene(d: Dict[str, torch.Tensor]) -> GaussianScene:
    return GaussianScene(**d)


def camera(d: Dict[str, Any]) -> Camera:
    return Camera(**d)


def render(scene_d: Dict[str, torch.Tensor], cams: Dict[str, Any],
           background: torch.Tensor, rcfg: RasterizeConfig) -> torch.Tensor:
    """The program's render of a scene (the ground truth's images)."""
    with torch.inference_mode():
        return render_images_stats(scene(scene_d), camera(cams), background,
                                   rcfg)[0]


def calibrate(samples, how: str) -> RasterizeConfig:
    """``default``: the JAX package's budgets; ``calibrate``: sized from the
    (scene dict, cameras dict) samples by ops/calibrate.py."""
    if how == "default":
        return RasterizeConfig()
    if how != "calibrate":
        raise ValueError(f"raster {how!r}")
    return calibrate_raster_config([(scene(s), camera(c)) for s, c in samples])


# ops/downsample.py's three methods, each returning (coord, feat, mask,
# index): the cluster row of each point (fps, voxel) or the kept indices
# (random); its downsample_dispatch looks them up by name at each call
_REDUCERS = ("fps_knn_downsample", "voxel_downsample", "random_downsample")


def record_downsampling(sink: Callable[[tuple], None]) -> Callable[[], None]:
    """Hand every reduced set the program's input downsampling makes to
    ``sink`` (the tensors themselves: nothing is copied or computed), and
    return what undoes it."""
    mod = downsample_module
    kept = {name: getattr(mod, name) for name in _REDUCERS}

    def recorder(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink(out)
            return out
        return recorded
    for name, fn in kept.items():
        setattr(mod, name, recorder(fn))

    def undo() -> None:
        for name, fn in kept.items():
            setattr(mod, name, fn)
    return undo
