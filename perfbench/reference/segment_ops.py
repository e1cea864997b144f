"""Segment reductions and patch padding (a frozen copy of
splatformer_tpu_torch/ops/segment_ops.py). Segment ids must lie in
[0, num_segments)."""
from __future__ import annotations

import torch


def _index(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return segment_ids.to(torch.int64).reshape(
        (-1,) + (1,) * (data.ndim - 1)).expand_as(data)


def segment_sum(data, segment_ids, num_segments):
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


def segment_max(data, segment_ids, num_segments, fill=0.0):
    """Per-segment max; empty segments take ``fill``."""
    out = data.new_full((num_segments,) + data.shape[1:], -torch.inf)
    out = out.scatter_reduce_(0, _index(segment_ids, data), data, "amax")
    return torch.where(torch.isfinite(out), out, torch.full_like(out, fill))


def segment_mean(data, segment_ids, num_segments):
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments)
    return s / torch.clamp(cnt, min=1.0).reshape(
        (-1,) + (1,) * (data.ndim - 1))


def pad_order_for_patches(order_perm: torch.Tensor, n_valid: torch.Tensor,
                          patch_size: int) -> torch.Tensor:
    """Fill the fake slots of the boundary patch with cyclic duplicates of
    that patch's real points (Pointcept's get_padding_and_inverse), so the
    tail patch attends over real points only. Slots of fully fake patches
    stay as they are; the inverse permutation never reads them."""
    n = order_perm.shape[0]
    k = patch_size
    idx = torch.arange(n, dtype=torch.int64, device=order_perm.device)
    n_valid = n_valid.to(torch.int64)
    m = n_valid % k
    patch_start = n_valid - m
    dup = patch_start + (idx - patch_start) % torch.clamp(m, min=1)
    use_dup = (idx >= n_valid) & (idx < patch_start + k) & (m > 0)
    return order_perm[torch.where(use_dup, dup, idx)]
