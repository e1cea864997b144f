"""Multi-view rendering (port of splatformer_tpu/ops/render.py, its flat
multi-view path).

All V views run as ONE pipeline over a virtual image of V * tiles-per-view
tiles: one fused launch of the projection kernel (P1, kernels/projection.py:
activation, projection, SH colours and entry packing of every view, written
in the flat layout), then one binning sort, one entry gather and one launch
of the K1 compositing kernel (kernels/composite.py) for the whole batch.
There is one path; the device of the scene picks the kernels (CUDA) or
their plain versions (CPU). The render is differentiable in all six scene
attributes: the backward of the compositing is the K2 kernel, that of the
projection P1's backward kernel, the rest is autograd.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.kernels.projection import project_views
from splatformer_tpu_torch.ops.binning import TileBins, bin_gaussians
from splatformer_tpu_torch.ops.raster import composite_packed, gather_entries
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)


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
    with tracing.span("render.project"):
        views = project_views(scene, cameras, config)
        tracing.count("render.project.views", v)
    with tracing.span("render.bin"):
        bins = bin_gaussians(views.proj, cameras.height, cameras.width,
                             config.tile_size, v * config.max_intersects,
                             config.tiles_per_gauss,
                             tile_offset=views.tile_offset, num_images=v,
                             tiers=config.tiers)
    with tracing.span("render.gather"):
        packed_t = gather_entries(views.packed_t, bins.gauss_idx)
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
