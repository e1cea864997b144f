"""Gaussian-axis sharded differentiable rendering (port of
splatformer_tpu/parallel/gauss_shard.py).

One scene's N Gaussians are split into G contiguous shards, and the image
is produced cooperatively:

  1. **send** (per shard): activation, SH, projection and tile binning of
     the shard over the FULL image, one view at a time as the JAX body's
     ``vmap``; the tile rows are partitioned statically (destination d owns
     a contiguous block of tile rows), and the tile-sorted entry list is
     sliced into per-destination runs with one searchsorted over the
     destinations' tile bounds, into fixed-budget (G, V, B) buffers of a
     merge key and a 9-float payload [x, y, conic0-2, opacity, r, g, b];
  2. **exchange**: the buffers go to their destinations, source-major: an
     ``AllToAll`` over a process group (one shard a process), or, in one
     process holding every shard, a stack and a transpose
     (``LocalShards``); both are differentiable;
  3. **merge and composite** (per destination): one stable sort of the
     G * V * B received keys, whose ties keep source-major order (global
     Gaussian order, as the unsharded binning's stable sort), the
     destination's per-tile ranges, the y shift by its first pixel row, and
     ONE launch of the compositing kernel K1 (its backward K2) over all
     views' row blocks (ops/raster.py:composite_packed).

The merge key of an entry is ``(view * tiles_loc + local tile) * 2^32 +
(depth key + 2^31)``: the signed int32 depth key made non-negative, so one
int64 sort orders (tile, depth) as ``lax.sort(num_keys=2)`` does; the
tile is local to the destination's row block and offset by the view, so
that one sort and one kernel launch serve every view. An unsent slot
carries the key of tile ``V * tiles_loc``, past every real one.

The gradient flows from each destination's pixels back through the merge
gather and the exchange's transpose to every shard's Gaussian attributes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from splatformer_tpu_torch.ops.binning import bin_gaussians, depth_key_i32
from splatformer_tpu_torch.ops.camera import opengl_c2w_to_opencv_w2c
from splatformer_tpu_torch.ops.projection import (activate_gaussians,
                                                  compute_colors,
                                                  project_gaussians)
from splatformer_tpu_torch.ops.raster import (PACK_W, composite_packed,
                                              gather_entries, pack_entries_t)
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)
from splatformer_tpu_torch.parallel.collectives import (AllToAll,
                                                        all_gather_rows,
                                                        group_rank,
                                                        group_size)

GAUSS_AXIS = "gauss"
PAYLOAD = 9        # x, y, conic0-2, opacity, r, g, b (ops/raster.py rows)
DEPTH_BIAS = 2 ** 31


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclass(frozen=True)
class RowBlocks:
    """The static split of an image's tile rows over G destinations:
    destination d owns tile rows [d * tiles_y_loc, (d + 1) * tiles_y_loc)
    (the last ones may own fewer, or none), rendered as ``rows_loc`` pixel
    rows."""

    height: int
    width: int
    tile_size: int
    n_dev: int

    @property
    def tiles_x(self) -> int:
        return _cdiv(self.width, self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * _cdiv(self.height, self.tile_size)

    @property
    def tiles_loc(self) -> int:
        return _cdiv(_cdiv(self.height, self.tile_size), self.n_dev) \
            * self.tiles_x

    @property
    def rows_loc(self) -> int:
        return self.tiles_loc // self.tiles_x * self.tile_size

    def dest_bounds(self, device) -> torch.Tensor:
        """(G + 1,) first tile of each destination, clipped to the image."""
        return torch.clamp(torch.arange(self.n_dev + 1, device=device)
                           * self.tiles_loc, max=self.num_tiles)


class ShardSend(NamedTuple):
    keys: torch.Tensor     # (G, V, B) int64 merge keys, by destination
    payload: torch.Tensor  # (G, V, 9, B) float32
    dropped: torch.Tensor  # () entries lost to the binning or the budget


def send_shard(scene: GaussianScene, cameras: Camera,
               config: RasterizeConfig, geo: RowBlocks,
               budget: int) -> ShardSend:
    """Project and bin one shard over the full image, view by view, and
    cut its entries into per-destination runs of at most ``budget``.
    ``dropped`` is the most any view lost (splatformer_tpu/parallel/
    gauss_shard.py:85-128)."""
    dev = scene.means.device
    i_loc = config.max_intersects
    act = activate_gaussians(scene)
    mask = scene.valid_mask()
    opacities = torch.where(mask, act["opacities"],
                            torch.zeros_like(act["opacities"]))
    dest_bounds = geo.dest_bounds(dev)
    slot = torch.arange(budget, device=dev)[None, :]
    sentinel = (cameras.c2w.shape[0] * geo.tiles_loc) << 32
    keys, pays, dropped = [], [], []
    for v in range(cameras.c2w.shape[0]):
        c2w = cameras.c2w[v]
        proj = project_gaussians(
            act["means"], act["scales"], act["quats"],
            opengl_c2w_to_opencv_w2c(c2w), cameras.fx[v], cameras.fy[v],
            cameras.cx[v], cameras.cy[v], geo.height, geo.width,
            tile_size=geo.tile_size, clip_thresh=config.clip_thresh,
            mask=mask, opacities=opacities,
            alpha_threshold=config.alpha_threshold)
        bins = bin_gaussians(proj, geo.height, geo.width, geo.tile_size,
                             i_loc, config.tiles_per_gauss,
                             tiers=config.tiers)
        colors = compute_colors(scene, c2w[:3, 3])
        payload = gather_entries(pack_entries_t(
            proj.xys, proj.conics, colors, opacities)[:PAYLOAD],
            bins.gauss_idx)                                 # (9, i_loc)
        depth = depth_key_i32(proj.depths)[bins.gauss_idx.long()]

        # the tile-sorted list's run for each destination (live entries
        # only: a dead entry's tile is num_tiles, past every bound)
        bounds = torch.searchsorted(bins.tile_ids, dest_bounds.to(
            torch.int32), side="left")
        idx = bounds[:-1, None] + slot                      # (G, B)
        valid = idx < bounds[1:, None]
        idx_c = torch.clamp(idx, max=i_loc - 1)
        tile = (bins.tile_ids[idx_c].long() - dest_bounds[:-1, None]
                + v * geo.tiles_loc)
        key = (tile << 32) + (depth[idx_c].long() + DEPTH_BIAS)
        keys.append(torch.where(valid, key, torch.full_like(key, sentinel)))
        pays.append(torch.where(valid[None], payload[:, idx_c],
                                torch.zeros((), device=dev)).transpose(0, 1))
        dropped.append(torch.clamp(bounds[1:] - bounds[:-1] - budget,
                                   min=0).sum() + bins.num_dropped)
    return ShardSend(keys=torch.stack(keys, dim=1),
                     payload=torch.stack(pays, dim=1),
                     dropped=torch.stack(dropped).max())


def merge_entries(keys: torch.Tensor, payload: torch.Tensor, dest: int,
                  n_views: int, geo: RowBlocks
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination ``dest``'s compositing input from the (G, V, B) keys and
    (G, V, 9, B) payloads it received, source-major: the packed entries
    (16, G * V * B) sorted by (view, tile, depth), y in the row block's own
    pixel frame, and the (V * tiles_loc + 1,) per-tile ranges."""
    sorted_keys, order = torch.sort(keys.reshape(-1), stable=True)
    entries = payload.permute(2, 0, 1, 3).reshape(PAYLOAD, -1) \
        .index_select(1, order)
    tile_start = torch.searchsorted(
        sorted_keys >> 32, torch.arange(n_views * geo.tiles_loc + 1,
                                        device=keys.device),
        side="left").to(torch.int32)
    row0 = float(dest * geo.rows_loc)
    packed_t = torch.cat([
        entries[0:1], entries[1:2] - row0, entries[2:],
        entries.new_zeros((PACK_W - PAYLOAD, entries.shape[1]))])
    return packed_t, tile_start


def composite_row_blocks(packed_t: torch.Tensor, tile_start: torch.Tensor,
                         n_views: int, background: torch.Tensor,
                         config: RasterizeConfig, geo: RowBlocks
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K1 launch (K2 in the backward) over every view's row block: rgb
    (V, rows_loc, W, 3) clamped to [., 1] and alpha (V, rows_loc, W, 1)."""
    rgb, alpha = composite_packed(
        packed_t, tile_start, geo.rows_loc, geo.width, geo.tile_size,
        background, alpha_threshold=config.alpha_threshold,
        max_alpha=config.max_alpha,
        transmittance_eps=config.transmittance_eps, num_images=n_views)
    rgb = torch.minimum(rgb, torch.ones_like(rgb))  # ties as jnp.clip
    return rgb, alpha[..., None]


class GroupExchange:
    """One shard a process: the processes of a gauss group exchange their
    buffers with ``AllToAll`` (``group=None``: a group of one process)."""

    def __init__(self, group=None):
        self.group = group
        self.size = group_size(group)
        self.indices = (group_rank(group),)

    def exchange(self, sends: Sequence[ShardSend]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        (send,) = sends
        return [(AllToAll.apply(send.keys, self.group),
                 AllToAll.apply(send.payload, self.group))]

    def gather_rows(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        (block,) = blocks
        return all_gather_rows(block, self.group, dim=1)


class LocalShards:
    """All G shards of a gauss group in this one process: the exchange is a
    stack of the G send buffers and a transpose of their (source,
    destination) axes, with the same result as G processes' AllToAll."""

    group = None

    def __init__(self, n_shards: int):
        self.size = n_shards
        self.indices = tuple(range(n_shards))

    def exchange(self, sends: Sequence[ShardSend]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        keys = torch.stack([s.keys for s in sends]).transpose(0, 1)
        pays = torch.stack([s.payload for s in sends]).transpose(0, 1)
        return list(zip(keys.unbind(), pays.unbind()))

    def gather_rows(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(blocks), dim=1)


def as_exchange(gauss) -> "GroupExchange | LocalShards":
    """A LocalShards or GroupExchange as given; a process group (or None,
    one process) wrapped in a GroupExchange."""
    if isinstance(gauss, (GroupExchange, LocalShards)):
        return gauss
    return GroupExchange(gauss)


def shard_scene(scene: GaussianScene, index: int, n_loc: int
                ) -> GaussianScene:
    """Shard ``index`` of a scene cut into contiguous blocks of ``n_loc``
    Gaussians (the shard_map in_spec P(axis) on every leaf)."""
    def cut(x):
        return None if x is None else x[index * n_loc:(index + 1) * n_loc]
    return scene.replace(**{k: cut(getattr(scene, k)) for k in (
        "means", "scales", "quats", "opacities", "features_dc",
        "features_rest", "mask")})


def render_row_blocks(shards: Sequence[GaussianScene], cameras: Camera,
                      background: torch.Tensor, config: RasterizeConfig,
                      exchange, height: Optional[int] = None,
                      width: Optional[int] = None,
                      exchange_budget: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 List[torch.Tensor]]:
    """Render this process's shards (one per ``exchange.indices`` entry)
    and composite its destinations' row blocks: (rgb blocks (V, rows_loc,
    W, 3), alpha blocks (V, rows_loc, W, 1), dropped per shard), one each
    per local index. ``exchange_budget`` is the per-(source, destination)
    entry budget; the default, the per-shard binning budget
    ``config.max_intersects``, can never drop."""
    geo = RowBlocks(height or cameras.height, width or cameras.width,
                    config.tile_size, exchange.size)
    budget = exchange_budget or config.max_intersects
    sends = [send_shard(s, cameras, config, geo, budget) for s in shards]
    received = exchange.exchange(sends)
    views = cameras.c2w.shape[0]
    rgbs, alphas = [], []
    for dest, (keys, payload) in zip(exchange.indices, received):
        packed_t, tile_start = merge_entries(keys, payload, dest, views, geo)
        rgb, alpha = composite_row_blocks(packed_t, tile_start, views,
                                          background, config, geo)
        rgbs.append(rgb)
        alphas.append(alpha)
    return rgbs, alphas, [s.dropped for s in sends]


def render_images_gauss_sharded(
    scene: GaussianScene,
    cameras: Camera,
    background: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    gauss=None,
    exchange_budget: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render V views of one scene whose Gaussians are sharded over
    ``gauss``: a gauss process group (each process renders its shard of the
    scene it is given, all processes the same scene), ``None`` (one
    process, one shard) or a ``LocalShards`` (every shard here). Returns
    (rgb (V, H, W, 3), alpha (V, H, W, 1)), on every process the whole
    image; each process's gradient flows through its own row block, so a
    loss that every process computes on the whole image back-propagates
    once. N must be a multiple of the number of shards."""
    ex = as_exchange(gauss)
    n = scene.num_points
    if n % ex.size:
        raise ValueError(f"{n} Gaussians do not split into {ex.size} "
                         "shards: pad N to a multiple of the gauss axis")
    shards = [shard_scene(scene, g, n // ex.size) for g in ex.indices]
    rgbs, alphas, _ = render_row_blocks(shards, cameras, background, config,
                                        ex, exchange_budget=exchange_budget)
    h = cameras.height
    return (ex.gather_rows(rgbs)[:, :h], ex.gather_rows(alphas)[:, :h])
