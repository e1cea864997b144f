"""Input-level point-cloud downsampling (port of
splatformer_tpu/ops/downsample.py): farthest-point sampling with 1-NN
cluster means, voxel-grid averaging and random keep, each with the map that
broadcasts the backbone's outputs on the reduced set back to the original
points.

Static capacities as in the JAX package: M = the kept count rounded up to a
multiple of 128 (at most N rounded up), a mask for the live rows, and a
waste bucket M for masked or overflowing points. Plain PyTorch: the JAX
package computes all of this in XLA outside any kernel.

  * FPS is m sequential steps (a ``lax.scan`` in the JAX package). On the
    card they are one launch of the F1 kernel (kernels/fps.py); on the CPU,
    and as the kernel's oracle on any device, a loop of a few launches a
    step (``furthest_point_sampling_plain``), which the kernel repeats bit
    for bit.
  * ``nearest_idx`` relies on float32 matmuls (the JAX package asks for
    ``Precision.HIGHEST``); the package keeps TF32 off for this.
  * ``random`` takes its uniform scores from ``uniform`` (a callable
    ``shape -> tensor``): the caller's generator in training, a CPU
    generator seeded 0 in evaluation, or injected draws. The JAX package
    draws ``jax.random.uniform`` (``jax.random.key(0)`` in evaluation),
    which torch cannot reproduce: the same distribution, another subset of
    points. Card and CPU keep the same subset.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.kernels.fps import furthest_point_sampling_kernel
from splatformer_tpu_torch.ops.segment_ops import segment_sum

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
    the first valid point; masked points are never chosen. CUDA tensors
    launch the F1 kernel or raise; CPU tensors take the plain loop."""
    if coord.device.type == "cpu":
        return furthest_point_sampling_plain(coord, mask, m)
    if coord.device.type != "cuda":
        raise ValueError(f"no FPS kernel for device {coord.device}")
    return furthest_point_sampling_kernel(coord, mask, m)


def furthest_point_sampling_plain(coord: torch.Tensor, mask: torch.Tensor,
                                  m: int) -> torch.Tensor:
    """The kernel's function as a loop of a few launches a pick, on any
    device: the picks of ``furthest_point_sampling``."""
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


def fps_knn_downsample(coord, feat, mask, ratio: float, patch_mult: int = 128):
    """-> (ds_coord, ds_feat, ds_mask, assign): FPS centroids, each point
    assigned to its nearest centroid (masked ones to the waste bucket M),
    the reduced points the clusters' means."""
    n = coord.shape[0]
    m_req = max(1, int(n * ratio))
    m = min(_round_up(m_req, patch_mult), _round_up(n, patch_mult))
    picks = min(m_req, m)
    tracing.count("refine.fps.picks", picks)
    centroids = furthest_point_sampling(coord, mask, picks)
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
    m = min(_round_up(max(patch_mult, int(n * capacity_factor)), patch_mult),
            _round_up(n, patch_mult))
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
    m = min(_round_up(max(1, int(n * ratio)), patch_mult),
            _round_up(n, patch_mult))
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


def downsample_dispatch(method: str, info: Dict[str, Any], coord, feat, mask,
                        uniform: Optional[Uniform] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   UpFn]:
    """-> (coord, feat, mask, up): the reduced set, and ``up`` mapping the
    backbone's outputs on it back to the original points (voxel and fps:
    each point's cluster row, zero for masked points; random: the nearest
    kept point's row). ``uniform`` draws random's scores; without it they
    come from a CPU generator seeded 0, so evaluation picks the same points
    on every device."""
    if method == "voxel":
        vc, vf, vm, assign = voxel_downsample(
            coord, feat, mask, float(info["voxel_size"]),
            capacity_factor=float(info.get("voxel_capacity_factor", 0.5)))
        return vc, vf, vm, _gather_up(assign, vc.shape[0])
    if method == "fps":
        fc, ff, fm, assign = fps_knn_downsample(
            coord, feat, mask, float(info["downsample_ratio"]))
        return fc, ff, fm, _gather_up(assign, fc.shape[0])
    if method == "random":
        n = coord.shape[0]
        scores = (uniform((n,)) if uniform is not None else torch.rand(
            n, generator=torch.Generator().manual_seed(0)))
        rc, rf, rm, _ = random_downsample(
            coord, feat, mask, float(info["downsample_ratio"]), scores)

        def up(y: torch.Tensor) -> torch.Tensor:
            return y.index_select(0, nearest_idx(coord, rc, rm))

        return rc, rf, rm, up
    raise NotImplementedError(method)
