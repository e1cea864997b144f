"""The reference's eval request and train steps, in plain float32 (TF32
off), from the same inputs the program gets: the weights made from the
seed, the scenes, the cameras and the training draws. It works out the
rest again: its own ground-truth render of the clean scene, its own raster
budgets, its own optimizer state."""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from perfbench.reference.calibrate import calibrate_raster_config
from perfbench.reference.feature_predictor import (FeaturePredictor,
                                                   feature_channels)
from perfbench.reference.lpips import LPIPS
from perfbench.reference.metrics import psnr, ssim
from perfbench.reference.optim import build_optimizer
from perfbench.reference.ptv3 import Block
from perfbench.reference.render import render_images_stats
from perfbench.reference.types import Camera, GaussianScene
from perfbench.reference import precision

SCENE_ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
               "features_rest")


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """TF32 off for the reference's products and convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def backbone_kwargs(bb: Dict[str, Any]) -> Dict[str, Any]:
    """PointTransformerV3 keywords from a configuration file's backbone,
    whose channels and patch are written out."""
    enc, dec, patch = bb["enc_channels"], bb["dec_channels"], bb["patch_size"]
    if not (enc and dec and patch):
        raise ValueError("the configuration must state its channels and "
                         "patch")
    return dict(
        enc_depths=tuple(bb["enc_depths"]), enc_channels=tuple(enc),
        enc_num_head=tuple(bb["enc_num_head"]),
        enc_patch_size=(patch,) * len(enc),
        dec_depths=tuple(bb["dec_depths"]), dec_channels=tuple(dec),
        dec_num_head=tuple(bb["dec_num_head"]),
        dec_patch_size=(patch,) * len(dec), stride=tuple(bb["stride"]),
        mlp_ratio=bb["mlp_ratio"], drop_path=bb["drop_path"],
        pool_capacity_factors=tuple(bb["pool_capacity_factors"]),
        turn_off_bn=bb["turn_off_bn"], embedding_type=bb["embedding_type"])


def build_model(model: Dict[str, Any], device,
                compute_dtype: Optional[torch.dtype] = None
                ) -> FeaturePredictor:
    """The reference FeaturePredictor of a configuration file's ``model``,
    in eval mode, with torch's default initialisation (load the seeded
    weights over it)."""
    if model["output_head_type"] != "mlp-relu":
        raise NotImplementedError(model["output_head_type"])
    with torch.device(device):
        net = FeaturePredictor(
            backbone_type=model["backbone_type"],
            sh_degree=model["sh_degree"],
            input_features=model["input_features"],
            output_features=model["output_features"],
            input_feat_to_mlp=model["input_feat_to_mlp"],
            output_head_nlayer=model["output_head_nlayer"],
            output_head_width=model["output_head_width"],
            output_features_type=model["output_features_type"],
            res_feature_activation=dict(model["res_feature_activation"]),
            max_scale_normalized=model["max_scale_normalized"],
            grid_resolution=model["grid_resolution"],
            backbone_kwargs=backbone_kwargs(model["backbone"]),
            compute_dtype=compute_dtype,
            additional_info=dict(model["additional_info"]))
    return net.eval()


def head_channels(model: Dict[str, Any]) -> Dict[str, Any]:
    """The heads' sizes, for the FLOP count."""
    ch = feature_channels(model["sh_degree"])
    in_ch = sum(ch[k] for k in model["input_features"])
    return {"in_channels": in_ch, "width": model["output_head_width"],
            "nlayer": model["output_head_nlayer"],
            "out_channels": [ch[k] for k in model["output_features"]]}


def scene(d: Dict[str, torch.Tensor]) -> GaussianScene:
    return GaussianScene(**d)


def camera(d: Dict[str, Any]) -> Camera:
    return Camera(**d)


def raster_config(scenes: List[GaussianScene], cams: Camera):
    """Budgets sized from these very scenes (margin 2), so nothing drops."""
    return calibrate_raster_config([(s, cams) for s in scenes])


@torch.no_grad()
def reduce(model: FeaturePredictor, noisy: Dict,
           lower: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """The reduced set that input downsampling makes of the scene (coord,
    feat, mask, index: downsample.py:reduce); ``lower`` as ``refine``."""
    with full_float32(), precision.lower(lower, noisy["means"].device):
        return model.reduce(scene(noisy))


@torch.no_grad()
def refine(model: FeaturePredictor, noisy: Dict,
           lower: Optional[str] = None,
           reduced: Optional[Sequence[torch.Tensor]] = None
           ) -> Dict[str, torch.Tensor]:
    """The refined scene's attributes, as the eval step's refine computes
    them; ``lower`` computes the products in TF32 or float8 (the
    control). With input downsampling, ``reduced`` (a ``reduce`` result,
    or the program's own reduced set) is the set the backbone runs on."""
    with full_float32(), precision.lower(lower, noisy["means"].device):
        refined = model(scene(noisy), reduced=reduced)
    return {k: getattr(refined, k) for k in SCENE_ATTRS}


@torch.no_grad()
def render_and_score(refined: Dict[str, torch.Tensor], mask: torch.Tensor,
                     clean: Dict, cams: Dict, background: torch.Tensor,
                     lower: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Render a refined scene and score it against the reference's own
    render of the clean scene, as the eval step does; ``lower`` composites
    bfloat16-rounded entries (the control)."""
    cam = camera(cams)
    with full_float32():
        refined_scene = scene(dict(refined, mask=mask))
        gt_scene = scene(clean)
        rcfg = raster_config([refined_scene, gt_scene], cam)
        gt = render_images_stats(gt_scene, cam, background, rcfg)[0]
        rgb, alpha, stats = render_images_stats(
            refined_scene, cam, background, rcfg,
            torch.bfloat16 if lower else None)
        return {"rgb": rgb, "alpha": alpha, "psnr": psnr(rgb, gt),
                "ssim": ssim(rgb, gt), "num_dropped": stats["num_dropped"]}


def set_block_rounding(model: FeaturePredictor, mode: Optional[str]) -> None:
    """Round the operands of every product inside PTv3's blocks (the
    control's lower precision in training; the backward keeps the blocks'
    compute dtype)."""
    for m in model.modules():
        if isinstance(m, Block):
            m.operand_rounding = mode


def train_steps(model: FeaturePredictor, lpips: LPIPS,
                batches: List[Dict], recipe: Dict[str, Any]
                ) -> Dict[str, Any]:
    """The recipe's steps on ``batches`` ({noisy, clean, cams, background,
    generator}): refine in train mode, render, L1 + LPIPS, backward, clip,
    Adam. Returns each step's loss, the first step's refined scene, the
    first step's gradients as the optimizer took them (clipped) and the
    parameters after the steps."""
    opt = build_optimizer(model, dict(recipe["lr_dict"]), recipe["optimizer"],
                          recipe["eps"], recipe["schedule"],
                          recipe["total_steps"], recipe["warmup_steps"],
                          recipe["grad_clip_norm"])
    lpips.requires_grad_(False)
    losses, first_grads, first_refined = [], None, None
    with full_float32():
        for i, b in enumerate(batches):
            cam = camera(b["cams"])
            noisy, gt_scene = scene(b["noisy"]), scene(b["clean"])
            rcfg = raster_config([noisy, gt_scene], cam)
            with torch.no_grad():
                gt = render_images_stats(gt_scene, cam, b["background"],
                                         rcfg)[0]
            model.train()
            opt.zero_grad()
            refined = model(noisy, b["generator"])
            if i == 0:
                first_refined = {k: getattr(refined, k).detach()
                                 for k in SCENE_ATTRS}
            rgb = render_images_stats(refined, cam, b["background"], rcfg)[0]
            loss = recipe["image_l1_loss_weight"] * torch.mean(
                torch.abs(rgb - gt))
            if recipe["lpips_loss_weight"] > 0:
                loss = loss + recipe["lpips_loss_weight"] * torch.mean(
                    lpips(rgb, gt))
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if i == 0:
                first_grads = {n: m / (1 - 0.9) for n, m in
                               zip(opt.names, opt.mu)}
            del refined, rgb, loss, gt
    return {"losses": losses, "first_grads": first_grads,
            "first_refined": first_refined,
            "params": {n: p.detach() for n, p in model.named_parameters()}}
