"""Submanifold sparse 3D convolution over voxelised point sets (port of
splatformer_tpu/ops/sparse_conv.py).

The neighbour map resolves each point's offset voxel to the voxel's
MIN-INDEX occupant (points sharing a voxel stay separate sites); the centre
tap is the point itself; an empty neighbour voxel or a masked point gives
-1. The map comes from one stable sort of the voxel keys and a searchsorted
of the 27 query keys per point: the stable sort keeps equal keys in index
order, so the first match is the min-index occupant. The conv is one gather
of the 27 neighbour rows and one matmul.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch

from splatformer_tpu_torch import tracing

_COORD_BITS = 10  # voxel coords < 1024
_INVALID_KEY = 2 ** 31 - 1
MISSING_ROWS = 1024


def pack_voxel_key(grid_coord: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """(N, 3) int voxel coords -> unique int32 key; masked -> invalid."""
    g = grid_coord.to(torch.int32)
    key = g[:, 0] | (g[:, 1] << _COORD_BITS) | (g[:, 2] << (2 * _COORD_BITS))
    return torch.where(mask, key, torch.full_like(key, _INVALID_KEY))


def conv_offsets(kernel_size: int = 3, device=None) -> torch.Tensor:
    """(K, 3) int32 offsets of a cubic kernel, centre included, row-major
    (the order of the (K, Cin, Cout) weight's first axis)."""
    r = kernel_size // 2
    offs = list(itertools.product(range(-r, r + 1), repeat=3))
    return torch.tensor(offs, dtype=torch.int32, device=device)


def build_neighbor_map(grid_coord: torch.Tensor, mask: torch.Tensor,
                       kernel_size: int = 3) -> torch.Tensor:
    """-> nbr (N, K) int32: the neighbour voxel's min-index occupant per
    offset, the point itself at the centre tap, -1 where the voxel is empty
    or the point is masked."""
    with tracing.span("refine.neighbor_map"):
        return _neighbor_map(grid_coord, mask, kernel_size)


def _neighbor_map(grid_coord: torch.Tensor, mask: torch.Tensor,
                  kernel_size: int) -> torch.Tensor:
    n = grid_coord.shape[0]
    dev = grid_coord.device
    offs = conv_offsets(kernel_size, dev)
    center = offs.shape[0] // 2

    keys = pack_voxel_key(grid_coord, mask)
    sorted_keys, sort_perm = torch.sort(keys, stable=True)

    nbr_coord = grid_coord[:, None, :].to(torch.int32) + offs[None, :, :]
    in_range = torch.all((nbr_coord >= 0) & (nbr_coord < (1 << _COORD_BITS)),
                         dim=-1)
    nbr_key = (nbr_coord[..., 0]
               | (nbr_coord[..., 1] << _COORD_BITS)
               | (nbr_coord[..., 2] << (2 * _COORD_BITS)))
    # out-of-range queries never match (valid keys < 2^30)
    nbr_key = torch.where(in_range, nbr_key,
                          torch.full_like(nbr_key, _INVALID_KEY - 1))

    pos = torch.searchsorted(sorted_keys, nbr_key.reshape(-1))
    pos = torch.clamp(pos, max=n - 1)
    found = sorted_keys[pos] == nbr_key.reshape(-1)
    nbr = torch.where(found, sort_perm[pos], -1).to(torch.int32).reshape(n, -1)

    nbr = torch.where(mask[:, None], nbr, torch.full_like(nbr, -1))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    nbr[:, center] = torch.where(mask, iota, torch.full_like(iota, -1))
    return nbr


def sparse_conv_apply(feat: torch.Tensor, nbr: torch.Tensor,
                      weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_k feat[nbr[:, k]] @ weight[k] (+ bias); missing neighbours
    contribute zero. feat (N, Cin), nbr (N, K), weight (K, Cin, Cout).

    Autograd gives the exact gradient: the gather's backward
    (``index_add_``) sums each row's cotangents over every (point, offset)
    that read it, which is what the JAX package's scatter-free custom_vjp
    computes with voxel sums and a flipped gather (a TPU scatter
    workaround)."""
    n, cin = feat.shape
    k = weight.shape[0]
    # missing neighbours read one of MISSING_ROWS zero rows appended to the
    # table, spread over them so that the backward's scatter-add does not
    # pile millions of additions onto one row (most of the 27 neighbour
    # voxels of a sparse cloud are empty)
    table = torch.cat([feat, feat.new_zeros((MISSING_ROWS, cin))], dim=0)
    spread = torch.arange(n * k, device=nbr.device).view(n, k) % MISSING_ROWS
    idx = torch.where(nbr >= 0, nbr.to(torch.int64), n + spread)
    gathered = table.index_select(0, idx.reshape(-1)).reshape(n, k * cin)
    out = gathered @ weight.reshape(k * cin, -1)
    if bias is not None:
        out = out + bias
    return out
