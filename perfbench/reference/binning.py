"""Tile binning: per-Gaussian tile ranges -> depth-sorted per-tile entry list
(a frozen copy of splatformer_tpu_torch/ops/binning.py, same static-budget semantics).

  1. per-Gaussian tile bbox and tile count;
  2. tiered candidate expansion: every Gaussian emits its first S1 tile
     slots, the top-K2 Gaussians by tile count emit [S1, S2), the top-K3
     emit [S2, S3); overflow beyond a Gaussian's tier is dropped and counted;
  3. one stable sort of the candidates on the int64 key
     ``tile << 32 | depth_key`` (the depth key is the bit pattern of the
     non-negative f32 depth, so it is >= 0 and the packed key orders
     (tile, depth) lexicographically; ties keep candidate order, i.e.
     Gaussian id within a tier, as the reference's stable two-key sort);
  4. key-threshold truncation to the ``max_intersects`` budget;
  5. per-tile [start, end) offsets via searchsorted, and exact per-Gaussian
     surviving counts (``gauss_starts``) for the render backward.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from perfbench.reference.projection import ProjectedGaussians, tile_bbox


class TileBins(NamedTuple):
    gauss_idx: torch.Tensor    # (max_intersects,) int32, sorted by (tile, depth)
    tile_ids: torch.Tensor     # (max_intersects,) int32, sentinel = num_tiles
    tile_start: torch.Tensor   # (num_tiles + 1,) int32 offsets into the list
    num_entries: torch.Tensor  # () int32 valid entries
    num_dropped: torch.Tensor  # () int32 entries lost to the caps
    gauss_starts: torch.Tensor  # (N + 1,) int32 exclusive cumsum of survivors


TIER1_SLOTS = 4
TIER2_K, TIER2_SLOTS = 4096, 16
TIER3_K = 512
_BASE_TILES = 256  # 256^2 image at tile_size 16


def auto_tiers(num_tiles: int) -> tuple:
    """(tier1_slots, tier2_k, tier2_slots, tier3_k) scaled from the 256^2
    baseline by sqrt(tiles-per-image ratio)."""
    f = max(1.0, math.sqrt(num_tiles / _BASE_TILES))
    return (int(math.ceil(TIER1_SLOTS * f)), int(math.ceil(TIER2_K * f)),
            int(math.ceil(TIER2_SLOTS * f)), int(math.ceil(TIER3_K * f)))


def depth_key_i32(depths: torch.Tensor) -> torch.Tensor:
    """Monotone non-negative-float -> int32 key at full f32 fidelity (positive
    IEEE floats compare like their bit patterns); non-finite -> +inf."""
    d = torch.where(torch.isfinite(depths), torch.clamp(depths, min=0.0),
                    torch.full_like(depths, math.inf))
    return d.to(torch.float32).contiguous().view(torch.int32)


def bin_gaussians(
    proj: ProjectedGaussians,
    img_height: int,
    img_width: int,
    tile_size: int,
    max_intersects: int,
    tiles_per_gauss: int,
    tile_offset: Optional[torch.Tensor] = None,
    num_images: int = 1,
    tiers: Optional[tuple] = None,
) -> TileBins:
    """Bin (Gaussian, tile) pairs into a depth-sorted per-tile entry list.

    With ``num_images`` V > 1 the caller concatenates the V per-view
    projections along the Gaussian axis and passes a per-Gaussian
    ``tile_offset`` (= view * tiles_per_image): the batch is binned as ONE
    virtual image of V * tiles_per_image tiles. ``max_intersects`` is then
    the total budget across views."""
    dev = proj.xys.device
    n = proj.xys.shape[0]
    tiles_x = (img_width + tile_size - 1) // tile_size
    tiles_y = (img_height + tile_size - 1) // tile_size
    num_tiles = tiles_x * tiles_y
    total_tiles = num_tiles * num_images

    t1, t2k, t2s, t3k = tiers if tiers is not None else auto_tiers(num_tiles)
    s1 = min(t1, tiles_per_gauss, num_tiles)
    s2 = min(t2s, tiles_per_gauss, num_tiles)
    s3 = min(tiles_per_gauss, num_tiles)
    k2 = min(t2k * num_images, n)
    k3 = min(t3k * num_images, n)

    tmin_x, tmin_y, tmax_x, tmax_y = tile_bbox(
        proj.xys, proj.radii_xy, tile_size, tiles_x, tiles_y)
    alive = proj.num_tiles_hit > 0
    span_w = torch.clamp(tmax_x - tmin_x, min=1)
    count = torch.where(alive, proj.num_tiles_hit,
                        torch.zeros_like(proj.num_tiles_hit))

    sentinel_tile = total_tiles + 1
    depth_k = depth_key_i32(proj.depths)
    all_idx = torch.arange(n, dtype=torch.int32, device=dev)

    def tier_candidates(g_idx, slot_lo: int, slot_hi: int):
        """(tile, depth key, gaussian) of slots [slot_lo, slot_hi) of the
        given Gaussians (None = all, in order), flattened row-major."""
        slots = torch.arange(slot_lo, slot_hi, dtype=torch.int32,
                             device=dev)[None, :]
        take = (lambda x: x) if g_idx is None else (lambda x: x[g_idx])
        w = take(span_w)[:, None]
        ty = take(tmin_y)[:, None] + torch.div(slots, w, rounding_mode="floor")
        tx = take(tmin_x)[:, None] + torch.remainder(slots, w)
        tile = ty * tiles_x + tx
        if tile_offset is not None:
            tile = tile + take(tile_offset)[:, None]
        valid = slots < take(count)[:, None]
        tile = torch.where(valid, tile, torch.full_like(tile, sentinel_tile))
        # invalid slots carry depth 0 so every sentinel candidate compares
        # identically against the budget threshold
        dep = torch.where(valid, take(depth_k)[:, None], torch.zeros_like(tile))
        gid = (all_idx if g_idx is None else g_idx)[:, None].expand_as(tile)
        return tile.reshape(-1), dep.reshape(-1), gid.reshape(-1)

    tiles1, dep1, gid1 = tier_candidates(None, 0, s1)
    parts_t, parts_d, parts_g = [tiles1], [dep1], [gid1]
    if s2 > s1 or s3 > s2:
        # count descending, ties by index (stable sort of -count)
        by_count = torch.sort(-count, stable=True).indices.to(torch.int32)
    if s2 > s1:
        idx2 = by_count[:k2]
        tiles2, dep2, gid2 = tier_candidates(idx2, s1, s2)
        parts_t.append(tiles2)
        parts_d.append(dep2)
        parts_g.append(gid2)
    if s3 > s2:
        idx3 = by_count[:k3]
        tiles3, dep3, gid3 = tier_candidates(idx3, s2, s3)
        parts_t.append(tiles3)
        parts_d.append(dep3)
        parts_g.append(gid3)

    tiles_c = torch.cat(parts_t)
    deps_c = torch.cat(parts_d)
    gidx = torch.cat(parts_g)
    if tiles_c.shape[0] < max_intersects + 1:
        pad = max_intersects + 1 - tiles_c.shape[0]
        tiles_c = torch.cat([tiles_c, torch.full((pad,), sentinel_tile,
                                                 dtype=torch.int32, device=dev)])
        deps_c = torch.cat([deps_c, torch.zeros(pad, dtype=torch.int32,
                                                device=dev)])
        gidx = torch.cat([gidx, torch.zeros(pad, dtype=torch.int32,
                                            device=dev)])

    key = (tiles_c.to(torch.int64) << 32) | deps_c.to(torch.int64)
    key_s, perm = torch.sort(key, stable=True)
    tiles_s = (key_s >> 32).to(torch.int32)
    gidx = gidx[perm]
    # key-threshold truncation: keep entries strictly below the first
    # (tile, depth) key past the budget, so the surviving set is a pure
    # function of each candidate's key (exact per-Gaussian counts below)
    k_star = key_s[max_intersects]

    def below_star(tile, dep):
        return ((tile.to(torch.int64) << 32) | dep.to(torch.int64)) < k_star

    entry_valid = key_s[:max_intersects] < k_star
    gidx = gidx[:max_intersects]
    tile_ids = torch.where(entry_valid, tiles_s[:max_intersects],
                           torch.full_like(tiles_s[:max_intersects],
                                           total_tiles))

    tile_start = torch.searchsorted(
        tile_ids, torch.arange(total_tiles + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)

    counts_surv = below_star(tiles1, dep1).reshape(n, s1).sum(
        dim=1, dtype=torch.int32)
    if s2 > s1:
        counts_surv.index_add_(0, idx2, below_star(tiles2, dep2).reshape(
            k2, s2 - s1).sum(dim=1, dtype=torch.int32))
    if s3 > s2:
        counts_surv.index_add_(0, idx3, below_star(tiles3, dep3).reshape(
            k3, s3 - s2).sum(dim=1, dtype=torch.int32))
    gauss_starts = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev),
         torch.cumsum(counts_surv, 0, dtype=torch.int32)])

    num_entries = gauss_starts[-1]
    num_dropped = (count.sum(dtype=torch.int32) - num_entries).to(torch.int32)
    return TileBins(gauss_idx=gidx, tile_ids=tile_ids, tile_start=tile_start,
                    num_entries=num_entries, num_dropped=num_dropped,
                    gauss_starts=gauss_starts)
