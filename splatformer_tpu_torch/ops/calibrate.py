"""Scene-derived sizing of the rasterization budgets (port of
splatformer_tpu/ops/calibrate.py).

The binning (ops/binning.py) runs on static budgets: tier slot caps, top-K
tier membership and the max_intersects truncation. A mis-sized budget
silently truncates renders (``num_dropped`` > 0). This module measures the
per-Gaussian tile-count distribution of sample scenes and views with the
projection op and sizes the tiers and budget so the measured workload fits
with margin. Budgets are rounded up to coarse buckets, as the JAX package
does, so both packages pick the same integers from the same samples.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from splatformer_tpu_torch.ops.camera import opengl_c2w_to_opencv_w2c
from splatformer_tpu_torch.ops.projection import (activate_gaussians,
                                                  project_gaussians)
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)


def _round_up(x: int, mult: int) -> int:
    return ((int(x) + mult - 1) // mult) * mult


@torch.no_grad()
def _tile_counts(scene: GaussianScene, cameras: Camera) -> np.ndarray:
    """(V, N) int32 per-view tile-hit counts (0 = culled/masked)."""
    act = activate_gaussians(scene)
    mask = scene.valid_mask()
    counts = []
    for i in range(cameras.c2w.shape[0]):
        proj = project_gaussians(
            act["means"], act["scales"], act["quats"],
            opengl_c2w_to_opencv_w2c(cameras.c2w[i]), cameras.fx[i],
            cameras.fy[i], cameras.cx[i], cameras.cy[i], cameras.height,
            cameras.width, tile_size=16, mask=mask)
        counts.append(proj.num_tiles_hit)
    return torch.stack(counts).cpu().numpy()


def measure_tile_stats(samples: Iterable[Tuple[GaussianScene, Camera]]
                       ) -> dict:
    """Tile-count statistics over (scene, cameras) samples: per-view hit
    totals, quantiles of the counts of Gaussians that hit a tile, and
    exceedance counts to size the tier top-Ks, each the worst over the
    samples (pooled statistics would let easy samples dilute the hardest,
    and the budget must fit every sample)."""
    counts = [_tile_counts(scene, cameras) for scene, cameras in samples]
    per_view_hits = np.concatenate(
        [c.sum(axis=1).reshape(-1) for c in counts])

    def per_sample(f, default):
        vals = []
        for c in counts:
            alive = c[c > 0]
            if alive.size:
                vals.append(f(c, alive))
        return max(vals) if vals else default

    return {
        "max_count": int(per_sample(lambda c, a: a.max(), 1)),
        "q99": int(per_sample(lambda c, a: np.quantile(a, 0.99), 1)),
        "q999": int(per_sample(lambda c, a: np.quantile(a, 0.999), 1)),
        "alive_per_view": float(per_sample(
            lambda c, a: (c > 0).sum(axis=1).mean(), 1.0)),
        "exceed_per_view": lambda thr: float(per_sample(
            lambda c, a: (c > thr).sum(axis=1).max(), 0.0)),
        "max_hits_per_view": int(per_view_hits.max()),
        "mean_hits_per_view": float(per_view_hits.mean()),
    }


def calibrate_raster_config(
    samples: Sequence[Tuple[GaussianScene, Camera]],
    base: RasterizeConfig = RasterizeConfig(),
    margin: float = 2.0,
) -> RasterizeConfig:
    """``base`` with tiers/max_intersects/tiles_per_gauss sized so the
    measured workload fits with ``margin`` headroom (num_dropped 0): every
    Gaussian gets slots for the 99th-percentile count, the top-K2 the
    99.9th, the top-K3 the maximum. Margin 2.0 covers what the samples do
    not show, such as the drift of refined scales in training."""
    stats = measure_tile_stats(samples)
    s1 = max(4, _round_up(stats["q99"], 2))
    s2 = max(s1 + 4, _round_up(int(stats["q999"] * margin), 4))
    s3 = max(s2 + 4, _round_up(int(stats["max_count"] * margin), 8))
    k2 = _round_up(max(stats["exceed_per_view"](s1) * margin, 256), 1024)
    k3 = _round_up(max(stats["exceed_per_view"](s2) * margin, 64), 512)
    budget = _round_up(int(stats["max_hits_per_view"] * margin), 65536)
    return dataclasses.replace(
        base, tiers=(int(s1), int(k2), int(s2), int(k3)),
        tiles_per_gauss=int(s3), max_intersects=int(budget))


def calibration_summary(rcfg: RasterizeConfig) -> str:
    return (f"tiers={rcfg.tiers} tiles_per_gauss={rcfg.tiles_per_gauss} "
            f"max_intersects={rcfg.max_intersects}")
