"""2-D (data x gauss) training: scene data parallelism composed with the
Gaussian-sharded render (port of splatformer_tpu/parallel/train2d.py).

The FeaturePredictor forward runs REPLICATED within each gauss group:
every member refines its data row's scene with the same generator (seeded
from the data index and the step, never the gauss index), then takes its
N / G shard of the refined scene, renders it through the exchange of
parallel/gauss_shard.py, composites its own pixel-row block and takes the
partial L1 of that block (rows past the image masked, the denominator the
whole image's V * H * W * 3). The SUM of the members' gradients is the
scene's gradient; the mean over the data group is the data-parallel
reduction. The metrics follow the same sums, with ``num_dropped`` the
members' mean.

The gauss group is either processes (one shard each, ``AllToAll``) or
``LocalShards(G)``: one process holds the whole group, runs one forward,
renders all G row blocks, sums the partial losses and runs one backward,
the same function with its gauss group inside one process.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from splatformer_tpu_torch.ops.types import RasterizeConfig
from splatformer_tpu_torch.parallel.collectives import (all_reduce_mean_,
                                                        all_reduce_sum_)
from splatformer_tpu_torch.parallel.gauss_shard import (RowBlocks,
                                                        as_exchange,
                                                        render_row_blocks,
                                                        shard_scene)
from splatformer_tpu_torch.parallel.mesh import (DATA_AXIS, GAUSS_AXIS,
                                                 Mesh, make_mesh_2d,
                                                 shard_batch_2d)
from splatformer_tpu_torch.training.train_step import (SceneBatch,
                                                       trainable_grads)

__all__ = ["DATA_AXIS", "GAUSS_AXIS", "make_mesh_2d", "make_train_step_2d",
           "shard_batch_2d"]


def make_train_step_2d(model, optimizer, mesh: Mesh,
                       raster_config: RasterizeConfig,
                       image_l1_loss_weight: float = 1.0,
                       height: Optional[int] = None,
                       width: Optional[int] = None,
                       exchange_budget: Optional[int] = None,
                       gauss=None):
    """Returns step(batch, generator=None, order_perm=None,
    merge_scores=None, downsample_scores=None) -> metrics on a (data,
    gauss) mesh: ``batch`` is this data row's scene (shard_batch_2d), the
    generator the same on every member of the gauss group. ``gauss``
    overrides the mesh's gauss group with an exchange of
    parallel/gauss_shard.py (``LocalShards(G)`` on a mesh of one gauss
    process). Build the model with ``bn_group=mesh.data_group``."""
    if gauss is not None and mesh.n_gauss != 1:
        raise ValueError("a LocalShards gauss group needs a mesh of one "
                         f"gauss process, not {mesh.n_gauss}")
    exchange = as_exchange(mesh.gauss_group if gauss is None else gauss)
    g_size = exchange.size

    def step(batch: SceneBatch, generator: Optional[torch.Generator] = None,
             order_perm: Optional[torch.Tensor] = None,
             merge_scores: Optional[Iterable[torch.Tensor]] = None,
             downsample_scores: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        v, h, w = batch.images.shape[:3]
        h, w = height or h, width or w
        geo = RowBlocks(h, w, raster_config.tile_size, g_size)
        refined = model(batch.scene, generator, order_perm, merge_scores,
                        downsample_scores)
        n = refined.num_points
        if n % g_size:
            raise ValueError(f"{n} Gaussians do not split into {g_size} "
                             "shards")
        shards = [shard_scene(refined, g, n // g_size)
                  for g in exchange.indices]
        rgbs, _, dropped = render_row_blocks(
            shards, batch.cameras, batch.background, raster_config,
            exchange, h, w, exchange_budget)
        # ground-truth rows of each block, padded to the row grid; rows
        # past the image are masked out of the loss
        rows = geo.rows_loc
        gt = torch.nn.functional.pad(
            batch.images, (0, 0, 0, 0, 0, rows * g_size - h))
        denom = float(v * h * w * 3)
        l1 = 0.0
        for d, rgb in zip(exchange.indices, rgbs):
            row_mask = (torch.arange(d * rows, (d + 1) * rows,
                                     device=rgb.device) < h)
            row_mask = row_mask.to(rgb.dtype)[None, :, None, None]
            l1 = l1 + torch.sum(torch.abs(rgb - gt[:, d * rows:(d + 1) * rows])
                                * row_mask) / denom
        loss = image_l1_loss_weight * l1
        loss.backward()
        grads = trainable_grads(model)
        all_reduce_sum_(grads, exchange.group)    # the scene's gradient
        all_reduce_mean_(grads, mesh.data_group)  # the DP reduction
        # metrics: SUM over gauss (num_dropped then back to the members'
        # mean), MEAN over data (splatformer_tpu/parallel/train2d.py:121-123)
        metrics = torch.stack([l1.detach(), loss.detach(),
                               torch.stack(dropped).sum().to(torch.float32)])
        all_reduce_sum_([metrics], exchange.group)
        metrics[2] /= g_size
        all_reduce_mean_([metrics], mesh.data_group)
        optimizer.step()
        return dict(zip(("image_l1", "total_loss", "num_dropped"),
                        metrics.unbind()))

    return step
