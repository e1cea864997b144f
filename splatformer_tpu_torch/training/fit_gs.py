"""Per-scene 3DGS fitting (port of splatformer_tpu/training/fit_gs.py): the
data factory's stand-in for nerfstudio's splatfacto, which the reference's
data generator runs to make the input 3DGS that SplatFormer refines.

A scene of ``capacity`` slots with a validity mask is fitted to posed
images with the port's renderer: each step renders one view through
``render_images_stats`` (V = 1; K1 forward, K2 backward on the card), L1 +
``ssim_weight`` x (1 - SSIM), one Adam a Gaussian attribute, and sums a
per-Gaussian densification score (the world-space mean-gradient norm x
focal length). Densification keeps the capacity fixed: the best-scored
candidates are paired with free slots (splits get a quat-rotated,
scale-shaped offset and both halves shrink; clones copy), then low-opacity
and over-large Gaussians are pruned; new slots get fresh Adam moments.
Schedules follow splatfacto's shape: warm-up, periodic densify, optional
opacity reset, SH bands unlocked one by one.

The JAX package runs the steps as ``lax.scan`` chunks cut at every event;
here a plain host loop runs them one after another, with the same host
draws: the view of each step, the SH band masks and the event order.
Densify's offset directions come from a CPU ``torch.Generator`` seeded
with the fit's seed (so a fit on the card and one on the CPU share them),
or from the caller.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.ops.render import (render_images,
                                              render_images_stats)
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)
from splatformer_tpu_torch.training.metrics import psnr, ssim
from splatformer_tpu_torch.training.optim import GaussianOptimizer


@dataclass(frozen=True)
class FitConfig:
    steps: int = 2000
    capacity: int = 2 ** 16
    # loss: (1 - w) * L1 + w * (1 - SSIM), splatfacto's mix
    ssim_weight: float = 0.2
    # per-attribute learning rates (scene normalised to unit extent)
    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 1.25e-4
    # densification
    warmup_steps: int = 300
    densify_every: int = 100
    densify_stop: int = 0  # 0 = 1/2 steps
    densify_grad_thresh: float = 4e-7
    split_scale_thresh: float = 0.01
    split_shrink: float = 1.6
    densify_budget_frac: float = 0.05
    prune_opacity: float = 0.005
    max_world_scale: float = 0.5
    reset_opacity_every: int = 1500
    sh_degree: int = 1
    sh_degree_interval: int = 500
    adam_eps: float = 1e-15


ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")


@dataclass
class FitState:
    params: Dict[str, torch.Tensor]
    mask: torch.Tensor            # (capacity,) bool
    opt: GaussianOptimizer
    grad_accum: torch.Tensor      # (capacity,) summed ||d means|| * focal
    grad_count: torch.Tensor      # (capacity,) visible-step counts


def _scene(params: Dict[str, torch.Tensor],
           mask: torch.Tensor) -> GaussianScene:
    return GaussianScene(mask=mask, **params)


def build_fit_optimizer(cfg: FitConfig, params: Dict[str, torch.Tensor]
                        ) -> GaussianOptimizer:
    """One Adam (eps ``adam_eps``) an attribute; the means' learning rate
    decays exponentially from lr_means to lr_means_final over ``steps``
    (optax.exponential_decay, float32 as optax computes it)."""
    lr0 = np.float32(cfg.lr_means)
    rate = np.float32(cfg.lr_means_final / cfg.lr_means)

    def means_lr(count: int) -> float:
        return float(lr0 * rate ** (np.float32(count)
                                    / np.float32(cfg.steps)))
    lrs = {"means": means_lr, "scales": cfg.lr_scales,
           "quats": cfg.lr_quats, "opacities": cfg.lr_opacities,
           "features_dc": cfg.lr_features_dc,
           "features_rest": cfg.lr_features_rest}
    return GaussianOptimizer(params, lrs, "adam", cfg.adam_eps)


def init_state(cfg: FitConfig, points: Optional[np.ndarray] = None,
               colors: Optional[np.ndarray] = None,
               n_init: Optional[int] = None, seed: int = 0,
               device="cuda") -> FitState:
    """Random (or point-cloud seeded) init inside the unit cube, splatfacto
    style: isotropic log-scales from the mean nearest-neighbour spacing,
    opacity logit(0.1), SH dc from the colours. Host numpy draws in the JAX
    package's order."""
    device = resolve_device(device)
    cap = cfg.capacity
    rng = np.random.default_rng(seed)
    if points is None:
        n_init = n_init or cap // 4
        points = rng.uniform(0.2, 0.8, (n_init, 3))
    n_init = points.shape[0]
    if n_init > cap:
        raise ValueError(f"{n_init} seed points exceed capacity {cap}")
    if colors is None:
        colors = rng.uniform(0.2, 0.8, (n_init, 3))
    # mean spacing from a subsample (brute-force NN on up to 2k points)
    sub = points[rng.permutation(n_init)[: min(n_init, 2048)]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    spacing = float(np.sqrt(d2.min(axis=1)).mean())
    log_scale = math.log(max(spacing, 1e-4))
    sh_rest = (cfg.sh_degree + 1) ** 2 - 1

    def padded(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n_init] = x
        return out

    # identity quats everywhere, padding included: a zero quaternion has a
    # NaN normalisation gradient, which Adam would spread
    quats = np.zeros((cap, 4), np.float32)
    quats[:, 0] = 1.0
    dc = (np.asarray(colors, np.float32) - 0.5) / 0.28209479177387814
    host = {
        "means": padded(np.asarray(points, np.float32), fill=0.5),
        "scales": padded(np.full((n_init, 3), log_scale, np.float32),
                         fill=-10.0),
        "quats": quats,
        "opacities": padded(np.full((n_init, 1), math.log(0.1 / 0.9),
                                    np.float32)),
        "features_dc": padded(dc),
        "features_rest": np.zeros((cap, sh_rest, 3), np.float32),
    }
    params = {k: torch.from_numpy(v).to(device).requires_grad_()
              for k, v in host.items()}
    mask = torch.from_numpy(np.arange(cap) < n_init).to(device)
    zeros = torch.zeros(cap, dtype=torch.float32, device=device)
    return FitState(params=params, mask=mask,
                    opt=build_fit_optimizer(cfg, params),
                    grad_accum=zeros, grad_count=zeros.clone())


def fit_loss(cfg: FitConfig, rcfg: RasterizeConfig,
             params: Dict[str, torch.Tensor], mask: torch.Tensor,
             camera: Camera, image: torch.Tensor, background: torch.Tensor,
             sh_band_mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, l1, ssim) of one view: ``camera`` is a batch of one, ``image``
    (H, W, 3); SH bands beyond ``sh_band_mask`` are gated off."""
    p = dict(params)
    p["features_rest"] = p["features_rest"] * sh_band_mask[:, None]
    rgb, _, _ = render_images_stats(_scene(p, mask), camera, background,
                                    rcfg)
    l1 = torch.mean(torch.abs(rgb[0] - image))
    s = ssim(rgb, image[None])[0]
    loss = (1.0 - cfg.ssim_weight) * l1 + cfg.ssim_weight * (1.0 - s)
    return loss, l1, s


def fit_step(cfg: FitConfig, rcfg: RasterizeConfig, state: FitState,
             camera: Camera, image: torch.Tensor, background: torch.Tensor,
             sh_band_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One fitting step on one view, in place: loss, gradients, the Adam
    updates and the densification statistics. Returns the step's loss, L1
    and SSIM as tensors (no host synchronisation)."""
    loss, l1, s = fit_loss(cfg, rcfg, state.params, state.mask, camera,
                           image, background, sh_band_mask)
    grads = dict(zip(ATTRS, torch.autograd.grad(
        loss, [state.params[k] for k in ATTRS])))
    state.opt.step(state.params, grads)
    with torch.no_grad():
        gnorm = torch.linalg.vector_norm(grads["means"], dim=-1) * camera.fx[0]
        state.grad_accum += gnorm
        state.grad_count += (gnorm > 0).float()
    return {"loss": loss.detach(), "l1": l1.detach(), "ssim": s.detach()}


def _quat_rotate(quats: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (N, 3) by wxyz quaternions (N, 4)."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1,
                                                     keepdim=True), min=1e-12)
    w, xyz = q[:, :1], q[:, 1:]
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v + w * t + torch.linalg.cross(xyz, t)


def densify_budget(cfg: FitConfig) -> int:
    return max(int(cfg.capacity * cfg.densify_budget_frac), 1)


def top_slots(score: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest scores and their indices, largest first, the lower
    index first among equal scores (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(score, descending=True, stable=True)
    return values[:k], idx[:k]


@torch.no_grad()
def densify(cfg: FitConfig, state: FitState,
            generator: Optional[torch.Generator] = None,
            offset_dir: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split / clone / prune at fixed capacity, in place; returns the number
    of Gaussians added (a tensor). The split offsets' directions are
    ``offset_dir`` (budget, 3), else standard normals from ``generator``
    (a CPU generator)."""
    params, mask = state.params, state.mask
    device = mask.device
    budget = densify_budget(cfg)
    avg = state.grad_accum / torch.clamp(state.grad_count, min=1.0)
    world_scale = torch.exp(torch.amax(params["scales"], dim=-1))
    cand = (avg > cfg.densify_grad_thresh) & mask
    score = torch.where(cand, avg, torch.full_like(avg, -math.inf))
    top_score, src = top_slots(score, budget)

    # free slots first: stable argsort of the mask (False < True)
    dst = torch.argsort(mask.to(torch.int32), stable=True)[:budget]
    ok = torch.isfinite(top_score) & ~mask[dst]

    is_split = world_scale[src] > cfg.split_scale_thresh
    if offset_dir is None:
        offset_dir = torch.randn((budget, 3), generator=generator)
    offset_dir = offset_dir.to(device=device, dtype=torch.float32)
    scales_src = params["scales"][src]
    offset = _quat_rotate(params["quats"][src],
                          offset_dir * torch.exp(scales_src))
    shrink = math.log(cfg.split_shrink)
    split_col = is_split[:, None]
    children = {
        "means": torch.where(split_col, params["means"][src] + offset,
                             params["means"][src]),
        "scales": torch.where(split_col, scales_src - shrink, scales_src)}
    for name in ATTRS:
        child = children.get(name, params[name][src])
        okb = ok.reshape((budget,) + (1,) * (child.dim() - 1))
        params[name][dst] = torch.where(okb, child, params[name][dst])
    # parents of splits shrink in place
    params["scales"][src] = torch.where((ok & is_split)[:, None],
                                        scales_src - shrink,
                                        params["scales"][src])
    mask = mask.clone()
    mask[dst] |= ok

    # prune
    opac = torch.sigmoid(params["opacities"][:, 0])
    world_scale = torch.exp(torch.amax(params["scales"], dim=-1))
    mask &= (opac > cfg.prune_opacity) & (world_scale < cfg.max_world_scale)

    # fresh Adam moments for the new Gaussians; every count is kept
    state.opt.reset_rows(dst[ok])
    state.mask = mask
    state.grad_accum = torch.zeros_like(state.grad_accum)
    state.grad_count = torch.zeros_like(state.grad_count)
    return ok.sum()


@torch.no_grad()
def reset_opacities(state: FitState, value: float = 0.01) -> None:
    """Clamp every opacity logit to at most logit(``value``), in place."""
    logit = math.log(value / (1.0 - value))
    state.params["opacities"].clamp_(max=logit)


def fit_gaussians(images: torch.Tensor, cameras: Camera,
                  cfg: FitConfig = FitConfig(),
                  rcfg: RasterizeConfig = RasterizeConfig(),
                  points: Optional[np.ndarray] = None,
                  colors: Optional[np.ndarray] = None,
                  background: Optional[torch.Tensor] = None,
                  seed: int = 0, log_every: int = 0,
                  ) -> Tuple[GaussianScene, Dict[str, float]]:
    """Fit a scene to posed images on their device. Returns (scene, the last
    step's metrics and the live count ``n_gauss``).

    images: (V, H, W, 3) in [0, 1]; cameras: batched Camera (V views)."""
    device = images.device
    v = images.shape[0]
    background = (torch.zeros(3, device=device) if background is None
                  else background.to(device))
    state = init_state(cfg, points=points, colors=colors, seed=seed,
                       device=device)
    generator = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    densify_stop = cfg.densify_stop or cfg.steps // 2
    sh_rest = (cfg.sh_degree + 1) ** 2 - 1

    # host draws as the JAX package makes them: a view a step, up front;
    # SH degree d unlocked at step >= d * interval
    view_idx = [int(rng.integers(v)) for _ in range(cfg.steps)]
    bands = []
    for deg in range(cfg.sh_degree + 1):
        band = torch.zeros(sh_rest, device=device)
        band[: (deg + 1) ** 2 - 1] = 1.0
        bands.append(band)
    views = [cameras.select(i) for i in range(v)]

    metrics: Dict[str, torch.Tensor] = {}
    for step in range(cfg.steps):
        i = view_idx[step]
        deg = min(step // max(cfg.sh_degree_interval, 1), cfg.sh_degree)
        metrics = fit_step(cfg, rcfg, state, views[i], images[i],
                           background, bands[deg])
        if (cfg.warmup_steps <= step < densify_stop
                and (step + 1) % cfg.densify_every == 0):
            densify(cfg, state, generator)
        if (cfg.reset_opacity_every
                and (step + 1) % cfg.reset_opacity_every == 0
                and step + 1 < densify_stop):
            reset_opacities(state)
        if log_every and (step + 1) % log_every == 0:
            m = {k: float(x) for k, x in metrics.items()}
            m["n_gauss"] = int(state.mask.sum())
            print(f"fit step {step + 1}: {m}", flush=True)

    scene = _scene({k: p.detach() for k, p in state.params.items()},
                   state.mask)
    out = {k: float(x) for k, x in metrics.items()}
    out["n_gauss"] = int(state.mask.sum())
    return scene, out


@torch.no_grad()
def eval_fit(scene: GaussianScene, images: torch.Tensor, cameras: Camera,
             rcfg: RasterizeConfig = RasterizeConfig(),
             background: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Mean PSNR / SSIM of the fitted scene on the given views (one render
    of all of them)."""
    device = images.device
    background = (torch.zeros(3, device=device) if background is None
                  else background.to(device))
    rgb, _ = render_images(scene, cameras, background, rcfg)
    return {"psnr": float(torch.mean(psnr(rgb, images))),
            "ssim": float(torch.mean(ssim(rgb, images)))}
