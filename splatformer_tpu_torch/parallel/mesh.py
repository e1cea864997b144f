"""Process meshes (port of splatformer_tpu/parallel/mesh.py and
train2d.py's make_mesh_2d / shard_batch_2d).

The JAX package lays its devices on a ``jax.sharding.Mesh`` with a
``data`` axis (scene data parallelism) and, for the 2-D step, a ``gauss``
axis (one scene's Gaussians sharded). Here a process is a mesh position:
``Mesh`` holds this process's data group (the ranks with its gauss index)
and gauss group (the ranks with its data index), its index in each and
their sizes. Rank r of a (n_data, n_gauss) mesh sits at (r // n_gauss,
r % n_gauss), as the JAX package reshapes its device list.

Without an initialised process group a mesh is one rank: its groups are
None, which every collective of parallel/collectives.py reads as "one
rank". One process can also stand in for a whole gauss group
(parallel/gauss_shard.py:LocalShards).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"


@dataclass(frozen=True)
class Mesh:
    data_group: Optional[object]   # torch.distributed ProcessGroup or None
    gauss_group: Optional[object]
    data_index: int = 0
    gauss_index: int = 0
    n_data: int = 1
    n_gauss: int = 1


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D data mesh over every process of the world (``n_devices``, when
    given, must be the world size). With a process group initialised its
    data group is the world's, even at world size one."""
    rank, world = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} needs a world of "
                         f"{n_devices} processes, not {world}")
    if not dist.is_initialized():
        return Mesh(None, None)
    return Mesh(dist.group.WORLD, None, data_index=rank, n_data=world)


def make_mesh_2d(n_data: int, n_gauss: int) -> Mesh:
    """A (n_data, n_gauss) mesh over a world of n_data * n_gauss processes.
    Every rank creates every subgroup, in the same order (new_group is a
    collective over the world)."""
    rank, world = _world()
    if n_data * n_gauss != world:
        raise ValueError(f"a ({n_data}, {n_gauss}) mesh needs "
                         f"{n_data * n_gauss} processes, not {world}")
    if not dist.is_initialized():
        return Mesh(None, None)
    d, g = divmod(rank, n_gauss)
    data_group = gauss_group = None
    for gi in range(n_gauss):       # the data groups: one per gauss index
        grp = dist.new_group([gi + n_gauss * di for di in range(n_data)])
        if gi == g:
            data_group = grp
    for di in range(n_data):        # the gauss groups: one per data index
        grp = dist.new_group([di * n_gauss + gi for gi in range(n_gauss)])
        if di == d:
            gauss_group = grp
    return Mesh(data_group, gauss_group, data_index=d, gauss_index=g,
                n_data=n_data, n_gauss=n_gauss)


def shard_batch(mesh: Mesh, batches: Sequence):
    """This process's item of a list with one item a data row (the JAX
    package's leading device axis): row ``data_index``."""
    if len(batches) != mesh.n_data:
        raise ValueError(f"{len(batches)} items for {mesh.n_data} data rows")
    return batches[mesh.data_index]


def shard_batch_2d(mesh: Mesh, batches: Sequence):
    """The same on a 2-D mesh: row ``data_index``, replicated over gauss."""
    return shard_batch(mesh, batches)


def replicated(mesh: Mesh):
    """The group over which replicated state is kept equal: the data
    group (the JAX package's NamedSharding(mesh, P()))."""
    return mesh.data_group


def replicate_to_mesh(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """In place: every tensor takes rank 0's value over the data group (a
    broadcast from its first rank)."""
    group = mesh.data_group
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
