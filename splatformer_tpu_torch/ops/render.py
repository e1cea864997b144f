"""Multi-view rendering (port of splatformer_tpu/ops/render.py, its flat
multi-view path).

All V views run as ONE pipeline over a virtual image of V * tiles-per-view
tiles: per-view activation, SH colours, projection and entry packing, then
one binning sort, one entry gather and one launch of the K1 compositing
kernel (kernels/composite.py) for the whole batch. There is one path; the
device of the scene picks the kernel (CUDA) or its plain version (CPU).
The render is differentiable in all six scene attributes: the backward of
the compositing is the K2 kernel, the rest is autograd.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.ops import sh as sh_ops
from splatformer_tpu_torch.ops.binning import TileBins, bin_gaussians
from splatformer_tpu_torch.ops.camera import (normalize_quats,
                                              opengl_c2w_to_opencv_w2c)
from splatformer_tpu_torch.ops.projection import (ProjectedGaussians,
                                                  project_gaussians)
from splatformer_tpu_torch.ops.raster import (composite_packed,
                                              gather_entries, pack_entries_t)
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)


def activate_gaussians(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    """Raw -> rendering-space activations: exp(scales), renormalised quats
    with the degenerate fallback, sigmoid(opacities)."""
    return {
        "means": scene.means,
        "scales": torch.exp(scene.scales),
        "quats": normalize_quats(scene.quats),
        "opacities": torch.sigmoid(scene.opacities[..., 0]),
    }


def compute_colors(scene: GaussianScene, campos: torch.Tensor) -> torch.Tensor:
    """Per-view colours: sigmoid(features_dc) at SH degree 0, else SH along
    the camera->mean direction, clamp(rgb + 0.5, min=0). A Gaussian exactly
    at the camera takes the deterministic direction [0, 0, 1]."""
    degree = scene.sh_degree
    if degree == 0:
        return torch.sigmoid(scene.features_dc)
    coeffs = torch.cat([scene.features_dc[:, None, :], scene.features_rest],
                       dim=1)
    viewdirs = scene.means.detach() - campos.detach()
    norm = torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=viewdirs.dtype,
                            device=viewdirs.device)
    viewdirs = torch.where(norm > 0, viewdirs / torch.clamp(norm, min=1e-12),
                           fallback)
    rgb = sh_ops.eval_sh(degree, viewdirs, coeffs) + 0.5
    # maximum, not clamp: at a tie it splits the gradient as jnp.clip does
    return torch.maximum(rgb, torch.zeros_like(rgb))


class PackedEntries(NamedTuple):
    """What the compositing kernel consumes, plus the binning it came from."""

    packed_t: torch.Tensor   # (PACK_W, V * max_intersects) f32
    tile_start: torch.Tensor  # (V * tiles_img + 1,) int32
    bins: TileBins


def prepare_entries(scene: GaussianScene, cameras: Camera,
                    config: RasterizeConfig) -> PackedEntries:
    """Activation, SH, projection, flat binning and the entry gather for all
    V views of ``cameras`` (c2w (V, 3, 4), intrinsics (V,))."""
    v = cameras.c2w.shape[0]
    height, width, ts = cameras.height, cameras.width, config.tile_size
    tiles_img = ((width + ts - 1) // ts) * ((height + ts - 1) // ts)

    with tracing.span("render.project"):
        act = activate_gaussians(scene)
        mask = scene.valid_mask()
        opacities = torch.where(mask, act["opacities"],
                                torch.zeros_like(act["opacities"]))

        projs, packs = [], []
        for i in range(v):
            c2w = cameras.c2w[i]
            proj = project_gaussians(
                act["means"], act["scales"], act["quats"],
                opengl_c2w_to_opencv_w2c(c2w),
                cameras.fx[i], cameras.fy[i], cameras.cx[i], cameras.cy[i],
                height, width, tile_size=ts, clip_thresh=config.clip_thresh,
                mask=mask, opacities=opacities,
                alpha_threshold=config.alpha_threshold)
            colors = compute_colors(scene, c2w[:3, 3])
            projs.append(proj)
            packs.append(pack_entries_t(proj.xys, proj.conics, colors,
                                        opacities))

    # flatten (view, gaussian) onto one axis with the packed stride n_pad,
    # so the flat index v * n_pad + g addresses both the entry table and
    # the projection arrays; padded slots are zero (radius 0: never binned)
    n = scene.num_points
    n_pad = packs[0].shape[1]

    def flat(field):
        xs = [torch.nn.functional.pad(
            x, (0, 0) * (x.ndim - 1) + (0, n_pad - n)) for x in field]
        return torch.cat(xs, dim=0)

    with tracing.span("render.bin"):
        projf = ProjectedGaussians(*(flat(f) for f in zip(*projs)))
        tile_offset = torch.repeat_interleave(
            torch.arange(v, dtype=torch.int32, device=scene.means.device)
            * tiles_img, n_pad)
        bins = bin_gaussians(projf, height, width, ts,
                             v * config.max_intersects,
                             config.tiles_per_gauss, tile_offset=tile_offset,
                             num_images=v, tiers=config.tiers)
    with tracing.span("render.gather"):
        packed_t = gather_entries(torch.cat(packs, dim=1), bins.gauss_idx)
    return PackedEntries(packed_t=packed_t, tile_start=bins.tile_start,
                         bins=bins)


def render_images_stats(
    scene: GaussianScene,
    cameras: Camera,
    background: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Render V views -> (rgb (V, H, W, 3) clamped to [., 1], alpha
    (V, H, W, 1), {'num_dropped', 'num_entries'}). num_dropped > 0 means
    (gaussian, tile) pairs were lost to the tier caps or the budget."""
    with tracing.span("render"):
        entries = prepare_entries(scene, cameras, config)
        with tracing.span("render.composite"):
            rgb, alpha = composite_packed(
                entries.packed_t, entries.tile_start, cameras.height,
                cameras.width, config.tile_size, background,
                alpha_threshold=config.alpha_threshold,
                max_alpha=config.max_alpha,
                transmittance_eps=config.transmittance_eps,
                num_images=cameras.c2w.shape[0])
        rgb = torch.minimum(rgb, torch.ones_like(rgb))  # ties as jnp.clip
    stats = {"num_dropped": entries.bins.num_dropped,
             "num_entries": entries.bins.num_entries}
    return rgb, alpha[..., None], stats


def render_images(scene: GaussianScene, cameras: Camera,
                  background: torch.Tensor,
                  config: RasterizeConfig = RasterizeConfig(),
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """render_images_stats without the statistics."""
    rgb, alpha, _ = render_images_stats(scene, cameras, background, config)
    return rgb, alpha
