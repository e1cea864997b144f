"""Space-filling-curve serialization of point clouds (port of
splatformer_tpu/ops/serialization.py, bit-exact int32 codes).

Orders ("z", "z-trans", "hilbert", "hilbert-trans"); the -trans variants
swap x and y before encoding. Padded points get INVALID_CODE so they sort
to the tail, an invariant every consumer relies on.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from splatformer_tpu_torch import tracing

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
INVALID_CODE = 2 ** 31 - 1  # real codes use 3 * depth <= 30 bits


def _part1by2(x: torch.Tensor, depth: int) -> torch.Tensor:
    """Spread the low ``depth`` bits of x so bit i lands at position 3 i."""
    x = x.to(torch.int32) & ((1 << depth) - 1)
    out = torch.zeros_like(x)
    for i in range(depth):
        out = out | (((x >> i) & 1) << (3 * i))
    return out


def z_encode(grid_coord: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Morton key of (N, 3) int grid coords, x in bit 0, then y, then z."""
    x = _part1by2(grid_coord[:, 0], depth)
    y = _part1by2(grid_coord[:, 1], depth)
    z = _part1by2(grid_coord[:, 2], depth)
    return x | (y << 1) | (z << 2)


def hilbert_encode(grid_coord: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Hilbert key of (N, 3) int grid coords, 3 * depth bits (Skilling's
    transform, then bit interleave)."""
    n_dims = 3
    X = [grid_coord[:, i].to(torch.int32) & ((1 << depth) - 1)
         for i in range(n_dims)]

    Q = 1 << (depth - 1)
    while Q > 1:
        P = Q - 1
        for i in range(n_dims):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            X0_if = X[0] ^ P
            X0_else = X[0] ^ t
            Xi_else = X[i] ^ t
            X[0] = torch.where(cond, X0_if, X0_else)
            if i > 0:
                X[i] = torch.where(cond, X[i], Xi_else)
        Q >>= 1

    for i in range(1, n_dims):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = 1 << (depth - 1)
    while Q > 1:
        t = torch.where((X[n_dims - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(n_dims):
        X[i] = X[i] ^ t

    key = torch.zeros_like(X[0])
    for b in range(depth):
        for i in range(n_dims):
            bit = (X[i] >> (depth - 1 - b)) & 1
            key = (key << 1) | bit
    return key


def encode(grid_coord: torch.Tensor, order: str, depth: int = 10
           ) -> torch.Tensor:
    if order not in ORDERS:
        raise ValueError(f"unknown serialization order {order!r}")
    if order.endswith("-trans"):
        grid_coord = grid_coord[:, [1, 0, 2]]
    if order.startswith("z"):
        return z_encode(grid_coord, depth)
    return hilbert_encode(grid_coord, depth)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """Rows of permutations (..., N) -> their inverses, int32."""
    iota = torch.arange(perm.shape[-1], dtype=torch.int32,
                        device=perm.device).expand_as(perm)
    return torch.empty_like(iota).scatter_(-1, perm.to(torch.int64), iota)


def serialize(grid_coord: torch.Tensor, mask: torch.Tensor,
              orders: Sequence[str] = ORDERS, depth: int = 10,
              perm: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes, order_perm, inverse_perm), each (num_orders, N) int32:
    codes[o, i] is point i's key (INVALID_CODE for padding), order_perm[o, j]
    the point at serialized position j (stable in the point index),
    inverse_perm[o, i] the serialized position of point i. ``perm``
    permutes the order axis (PTv3's shuffle_orders in training)."""
    if depth * 3 > 30:
        raise ValueError("int32 keys support depth <= 10")
    with tracing.span("refine.serialize"):
        codes = torch.stack([encode(grid_coord, o, depth) for o in orders])
        codes = torch.where(mask[None, :], codes,
                            torch.full_like(codes, INVALID_CODE))
        if perm is not None:
            codes = codes[perm]
        order_perm = torch.sort(codes, dim=-1, stable=True).indices
        return (codes, order_perm.to(torch.int32),
                inverse_permutation(order_perm))
