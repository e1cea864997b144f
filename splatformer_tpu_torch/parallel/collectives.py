"""Differentiable collectives over a torch.distributed process group: the
port's counterparts of ``lax.psum`` and ``lax.all_to_all`` inside the JAX
package's ``shard_map`` bodies (``check_vma=False``).

``group=None`` means one rank: every function is then the identity (a
world of one process needs no process group). A group of size one runs its
collective all the same, which copies and changes no bit.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class AllReduceSum(torch.autograd.Function):
    """Forward: the SUM of ``x`` over ``group``. Backward: the SUM of the
    cotangent over ``group``, the transpose that ``psum`` has under
    ``shard_map(check_vma=False)``: each rank's input feeds every rank's
    output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        if group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        if ctx.group is not None:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class AllToAll(torch.autograd.Function):
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)`` over ``group`` on a
    leading axis of the group's size G: rank r's output row s is rank s's
    input row r. The backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if x.shape[0] != group_size(group):
        raise ValueError(f"leading axis {x.shape[0]} is not the group's "
                         f"size {group_size(group)}")
    x = x.contiguous()
    if group is None:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """In place: each tensor becomes its mean over ``group`` (``pmean``):
    one flat buffer per dtype, one SUM, one division by the group's size."""
    _all_reduce_flat(tensors, group, group_size(group))


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """In place: each tensor becomes its SUM over ``group`` (``psum``), one
    flat buffer per dtype."""
    _all_reduce_flat(tensors, group, 1)


def _all_reduce_flat(tensors: Sequence[torch.Tensor], group,
                     divisor: int) -> None:
    if group is None:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if divisor != 1:
            flat.div_(divisor)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_gather_rows(block: torch.Tensor, group, dim: int = 1
                    ) -> torch.Tensor:
    """The blocks of every rank of ``group`` concatenated along ``dim`` in
    rank order. Only this rank's own block carries a gradient: every rank
    that computes one loss of the whole gets, through its own block, the
    cotangent of that block (the row blocks of ``shard_map``'s
    ``out_specs=P(None, axis)``)."""
    if group is None:
        return block
    parts: List[torch.Tensor] = [torch.empty_like(block)
                                 for _ in range(group_size(group))]
    dist.all_gather(parts, block.detach().contiguous(), group=group)
    parts[group_rank(group)] = block
    return torch.cat(parts, dim=dim)


def scalars_mean(values: dict, group) -> dict:
    """{key: 0-d tensor} averaged over ``group`` (one all-reduce of the
    stacked values)."""
    if group is None or not values:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().to(torch.float32)
                           for k in keys])
    all_reduce_mean_([stacked], group)
    return dict(zip(keys, stacked.unbind()))
