"""PointBatch, the static-shape counterpart of Pointcept's ``Point`` (a frozen copy of
splatformer_tpu_torch/models/point.py): one scene padded to N points with a
validity mask, its four serialization orders precomputed."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from perfbench.reference.serialization import ORDERS, serialize


@dataclass
class PointBatch:
    coord: torch.Tensor         # (N, 3) float in [0, 1]
    grid_coord: torch.Tensor    # (N, 3) int32
    feat: torch.Tensor          # (N, C)
    mask: torch.Tensor          # (N,) bool, True = real point
    n_valid: torch.Tensor       # () int32; real points occupy serialized [0, n)
    codes: torch.Tensor         # (num_orders, N) int32 SFC keys
    order_perm: torch.Tensor    # (num_orders, N) int32
    inverse_perm: torch.Tensor  # (num_orders, N) int32

    @property
    def num_points(self) -> int:
        return self.feat.shape[0]

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)


def make_point_batch(coord: torch.Tensor, feat: torch.Tensor,
                     mask: torch.Tensor, grid_resolution: int = 384,
                     orders: Sequence[str] = ORDERS, depth: int = 10,
                     order_shuffle: Optional[torch.Tensor] = None,
                     ) -> PointBatch:
    """grid_coord = floor(coord * grid_resolution), clipped to the depth's
    range; ``order_shuffle`` permutes the orders (training), None keeps
    them (evaluation)."""
    grid_coord = torch.floor(coord * grid_resolution).to(torch.int32)
    grid_coord = torch.clamp(grid_coord, 0, (1 << depth) - 1)
    codes, order_perm, inverse_perm = serialize(grid_coord, mask, orders,
                                                depth, perm=order_shuffle)
    return PointBatch(
        coord=coord, grid_coord=grid_coord, feat=feat, mask=mask,
        n_valid=mask.sum().to(torch.int32), codes=codes,
        order_perm=order_perm, inverse_perm=inverse_perm)
