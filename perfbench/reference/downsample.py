"""Input-level point-cloud downsampling (a frozen copy of
splatformer_tpu_torch/ops/downsample.py): farthest-point sampling with 1-NN
cluster means, voxel-grid averaging and random keep, each with the map that
broadcasts the backbone's outputs on the reduced set back to the original
points.

Static capacities: M = the kept count rounded up to a multiple of 128 (at
most N rounded up), a mask for the live rows, and a waste bucket M for
masked or overflowing points. Plain float32 (the callers keep TF32 off).

FPS is chaotic: one ulp in a distance can change a pick and every pick
after it. This copy's arithmetic is what defines the right picks: the
squared distance as ``(coord - c).square().sum(dim=1)``, the running
minimum, the first index on ties of ``argmax``, the first valid point as
the first pick; the nearest centroid by the expanded distance
``q^2 - 2 q.r + r^2 + big`` with the first index on ties. Random keep's
scores come from ``uniform``, or in evaluation from a CPU generator seeded
0.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from perfbench.reference.segment_ops import segment_sum

_CHUNK = 2048
_INT32_MAX = 2 ** 31 - 1

Uniform = Callable[[Sequence[int]], torch.Tensor]
UpFn = Callable[[torch.Tensor], torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def nearest_idx(queries: torch.Tensor, refs: torch.Tensor,
                ref_mask: torch.Tensor) -> torch.Tensor:
    """(N, 3) queries -> index (N,) int64 of the nearest valid row of refs
    (M, 3), the first on ties; chunked over the queries to bound the
    (chunk, M) distance matrix."""
    ref2 = (refs * refs).sum(dim=1)
    big = torch.where(ref_mask, 0.0, torch.inf)
    out = []
    for q in torch.split(queries, _CHUNK):
        d = ((q * q).sum(dim=1)[:, None] - 2.0 * (q @ refs.T)
             + ref2[None, :] + big[None, :])
        out.append(d.argmin(dim=1))
    return torch.cat(out)


def furthest_point_sampling(coord: torch.Tensor, mask: torch.Tensor,
                            m: int) -> torch.Tensor:
    """(N, 3) -> (m,) int64 centroid indices by iterative FPS, starting at
    the first valid point; masked points are never chosen."""
    # masked points sit at -inf and stay there (min(-inf, d) = -inf)
    dist = torch.where(mask, 1e10, -torch.inf)
    farthest = mask.to(torch.int8).argmax().reshape(1)
    picks = []
    for _ in range(m):
        picks.append(farthest)
        d = (coord - coord.index_select(0, farthest)).square().sum(dim=1)
        torch.minimum(dist, d, out=dist)
        farthest = dist.argmax().reshape(1)
    return torch.cat(picks)


def _cluster_means(coord, feat, mask, assign, m):
    ones = mask.to(feat.dtype)
    cnt = segment_sum(ones, assign, m + 1)[:m]
    denom = torch.clamp(cnt, min=1.0)[:, None]
    ds_coord = segment_sum(coord * ones[:, None], assign, m + 1)[:m] / denom
    ds_feat = segment_sum(feat * ones[:, None], assign, m + 1)[:m] / denom
    return ds_coord, ds_feat, cnt


def fps_capacity(n: int, ratio: float, patch_mult: int = 128) -> int:
    """Rows of the reduced set that FPS and random keep give from ``n``
    slots."""
    return min(_round_up(max(1, int(n * ratio)), patch_mult),
               _round_up(n, patch_mult))


def voxel_capacity(n: int, capacity_factor: float = 0.5,
                   patch_mult: int = 128) -> int:
    """Rows of the reduced set that voxel averaging gives from ``n``
    slots."""
    return min(_round_up(max(patch_mult, int(n * capacity_factor)),
                         patch_mult), _round_up(n, patch_mult))


def fps_knn_downsample(coord, feat, mask, ratio: float, patch_mult: int = 128):
    """-> (ds_coord, ds_feat, ds_mask, assign): FPS centroids, each point
    assigned to its nearest centroid (masked ones to the waste bucket M),
    the reduced points the clusters' means."""
    n = coord.shape[0]
    m_req = max(1, int(n * ratio))
    m = fps_capacity(n, ratio, patch_mult)
    centroids = furthest_point_sampling(coord, mask, min(m_req, m))
    c_coord = torch.cat([coord.index_select(0, centroids),
                         coord.new_zeros((m - centroids.shape[0], 3))])
    c_mask = torch.arange(m, device=coord.device) < torch.clamp(
        mask.sum(), max=m_req)
    assign = torch.where(mask, nearest_idx(coord, c_coord, c_mask), m)
    ds_coord, ds_feat, cnt = _cluster_means(coord, feat, mask, assign, m)
    return ds_coord, ds_feat, c_mask & (cnt > 0), assign


def voxel_downsample(coord, feat, mask, voxel_size: float,
                     capacity_factor: float = 0.5, patch_mult: int = 128):
    """-> (ds_coord, ds_feat, ds_mask, assign): the means of the occupied
    voxels of edge ``voxel_size`` in key order, at most the capacity
    (overflowing voxels go to the waste bucket)."""
    n = coord.shape[0]
    m = voxel_capacity(n, capacity_factor, patch_mult)
    v = torch.floor(coord / voxel_size).to(torch.int32)
    key = v[:, 0] * 1_000_000 + v[:, 1] * 1_000 + v[:, 2]
    key = torch.where(mask, key, _INT32_MAX)
    skey, sidx = torch.sort(key, stable=True)
    valid_sorted = torch.arange(n, device=coord.device) < mask.sum()
    prev = torch.cat([skey.new_full((1,), -_INT32_MAX), skey[:-1]])
    is_head = valid_sorted & (skey != prev)
    cid_sorted = torch.cumsum(is_head, 0) - 1
    n_vox = is_head.sum()
    cid_sorted = torch.where(valid_sorted & (cid_sorted < m), cid_sorted, m)
    assign = torch.empty_like(cid_sorted).scatter_(0, sidx, cid_sorted)
    ds_coord, ds_feat, _ = _cluster_means(coord, feat, mask, assign, m)
    ds_mask = torch.arange(m, device=coord.device) < torch.clamp(n_vox, max=m)
    return ds_coord, ds_feat, ds_mask, assign


def random_downsample(coord, feat, mask, ratio: float, scores: torch.Tensor,
                      patch_mult: int = 128):
    """-> (coord, feat, ds_mask, keep): the valid points of lowest uniform
    ``scores`` (N,)."""
    n = coord.shape[0]
    m = fps_capacity(n, ratio, patch_mult)
    score = torch.where(mask, scores.to(coord.device), torch.inf)
    keep = torch.sort(score, stable=True).indices[:m]
    n_keep = torch.clamp(mask.sum(), max=int(n * ratio))
    ds_mask = torch.arange(m, device=coord.device) < n_keep
    return coord.index_select(0, keep), feat.index_select(0, keep), \
        ds_mask, keep


def _gather_up(assign: torch.Tensor, m: int) -> UpFn:
    def up(y: torch.Tensor) -> torch.Tensor:
        rows = y.index_select(0, torch.clamp(assign, 0, m - 1))
        return torch.where((assign < m)[:, None], rows, torch.zeros_like(rows))
    return up


def backbone_rows(info: Dict[str, Any], n: int) -> int:
    """Rows the backbone runs on from ``n`` slots: ``n`` without
    downsampling, else the reduced set's capacity."""
    method = info.get("downsample")
    if not method:
        return n
    if method == "voxel":
        return voxel_capacity(n, float(info.get("voxel_capacity_factor",
                                                0.5)))
    if method in ("fps", "random"):
        return fps_capacity(n, float(info["downsample_ratio"]))
    raise NotImplementedError(method)


def reduce(method: str, info: Dict[str, Any], coord, feat, mask,
           uniform: Optional[Uniform] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (coord, feat, mask, index): the reduced set of ``method`` and, for
    voxel and fps, each point's cluster row (M for masked points), for random
    the kept points' indices. ``uniform`` draws random's scores; without it
    they come from a CPU generator seeded 0."""
    if method == "voxel":
        return voxel_downsample(
            coord, feat, mask, float(info["voxel_size"]),
            capacity_factor=float(info.get("voxel_capacity_factor", 0.5)))
    if method == "fps":
        return fps_knn_downsample(coord, feat, mask,
                                  float(info["downsample_ratio"]))
    if method == "random":
        n = coord.shape[0]
        scores = (uniform((n,)) if uniform is not None else torch.rand(
            n, generator=torch.Generator().manual_seed(0)))
        return random_downsample(coord, feat, mask,
                                 float(info["downsample_ratio"]), scores)
    raise NotImplementedError(method)


def downsample_dispatch(method: str, info: Dict[str, Any], coord, feat, mask,
                        uniform: Optional[Uniform] = None,
                        reduced: Optional[Sequence[torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   UpFn]:
    """-> (coord, feat, mask, up): the reduced set, and ``up`` mapping the
    backbone's outputs on it back to the original points (voxel and fps:
    each point's cluster row, zero for masked points; random: the nearest
    kept point's row). ``reduced``, a result of ``reduce`` made elsewhere
    (the program's, where the comparison follows it stage by stage), takes
    the place of this one's own."""
    rc, rf, rm, index = (reduced if reduced is not None else
                         reduce(method, info, coord, feat, mask, uniform))
    if method == "random":
        def up(y: torch.Tensor) -> torch.Tensor:
            return y.index_select(0, nearest_idx(coord, rc, rm))
        return rc, rf, rm, up
    return rc, rf, rm, _gather_up(index, rc.shape[0])
