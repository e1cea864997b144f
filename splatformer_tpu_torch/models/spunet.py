"""SpUNet, the sparse-convolution U-Net backbone (port of
splatformer_tpu/models/spunet.py; the reference's SparseConvModel over
Pointcept's SpUNet-v1m1).

As in the JAX package, PTv3's serialized grid pooling stands in for the
strided sparse convolutions (the same voxel merge), each stage runs
residual 3^3 submanifold conv blocks (``sparse_conv_apply``), and the
decoder adds the skips through the cluster map (SerializedUnpooling). It
runs in float32 in training too: the JAX package gives it no compute
dtype. Module and parameter names follow the flax model's.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from splatformer_tpu_torch.models.layers import MaskedBatchNorm
from splatformer_tpu_torch.models.point import PointBatch
from splatformer_tpu_torch.models.ptv3 import (SerializedPooling,
                                               SerializedUnpooling, _round_up)
from splatformer_tpu_torch.ops.sparse_conv import (build_neighbor_map,
                                                   sparse_conv_apply)


class SparseConvBlock(nn.Module):
    """Residual 3^3 submanifold conv block: conv-BN-ReLU-conv-BN, plus the
    input (through a Linear ``shortcut`` when the width changes), ReLU."""

    def __init__(self, in_channels: int, channels: int, bn_group=None):
        super().__init__()
        for j, cin in enumerate((in_channels, channels)):
            self.register_parameter(f"conv{j}_kernel", nn.Parameter(
                torch.empty(27, cin, channels)))
            self.register_parameter(f"conv{j}_bias", nn.Parameter(
                torch.zeros(channels)))
            self.add_module(f"norm{j}", MaskedBatchNorm(channels,
                                                        group=bn_group))
        self.shortcut = (nn.Linear(in_channels, channels)
                         if in_channels != channels else None)

    def forward(self, feat: torch.Tensor, nbr: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h = feat
        for j in range(2):
            h = sparse_conv_apply(h, nbr, getattr(self, f"conv{j}_kernel"),
                                  getattr(self, f"conv{j}_bias"))
            h = getattr(self, f"norm{j}")(h, mask)
            if j == 0:
                h = F.relu(h)
        if self.shortcut is not None:
            feat = self.shortcut(feat)
        return F.relu(feat + h)


class SpUNet(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 256),
                 dec_channels: Sequence[int] = (96, 96, 128),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dec_depths: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (2, 2, 2),
                 pool_capacity_factors: Sequence[float] = (0.75, 0.625, 0.5),
                 output_dim: int = 96, bn_group=None):
        super().__init__()
        num_stages = len(channels)
        self.depths, self.dec_depths = tuple(depths), tuple(dec_depths)
        self.pool_capacity_factors = tuple(pool_capacity_factors)
        self.out_channels = output_dim
        self.stem = nn.Linear(in_channels, base_channels)
        self.stem_norm = MaskedBatchNorm(base_channels, group=bn_group)
        cur, widths = base_channels, []
        for s in range(num_stages):
            if s > 0:
                self.add_module(f"enc{s}_down", SerializedPooling(
                    cur, channels[s], stride[s - 1], bn_group=bn_group))
                cur = channels[s]
            for i in range(depths[s]):
                self.add_module(f"enc{s}_block{i}",
                                SparseConvBlock(cur, channels[s], bn_group))
                cur = channels[s]
            widths.append(cur)
        dec_ch = list(dec_channels) + [channels[-1]]
        for s in reversed(range(num_stages - 1)):
            self.add_module(f"dec{s}_up", SerializedUnpooling(
                cur, widths[s], dec_ch[s], bn_group=bn_group))
            cur = dec_ch[s]
            for i in range(dec_depths[s]):
                self.add_module(f"dec{s}_block{i}",
                                SparseConvBlock(cur, dec_ch[s], bn_group))
        self.head = nn.Linear(cur, output_dim)

    def forward(self, pb: PointBatch) -> torch.Tensor:
        num_stages = len(self.depths)
        h = F.relu(self.stem_norm(self.stem(pb.feat), pb.mask))
        pb = pb.replace(feat=h)
        skips, clusters, stage_nbrs = [], [], []
        for s in range(num_stages):
            if s > 0:
                cap = _round_up(max(128, int(
                    pb.num_points * self.pool_capacity_factors[s - 1])), 128)
                cap = min(cap, _round_up(pb.num_points, 128))
                child, cluster = self.get_submodule(f"enc{s}_down")(pb, cap)
                skips.append(pb)
                clusters.append(cluster)
                pb = child
            nbr = build_neighbor_map(pb.grid_coord, pb.mask)
            stage_nbrs.append(nbr)
            for i in range(self.depths[s]):
                pb = pb.replace(feat=self.get_submodule(f"enc{s}_block{i}")(
                    pb.feat, nbr, pb.mask))
        for s in reversed(range(num_stages - 1)):
            pb = self.get_submodule(f"dec{s}_up")(pb, skips[s], clusters[s])
            for i in range(self.dec_depths[s]):
                pb = pb.replace(feat=self.get_submodule(f"dec{s}_block{i}")(
                    pb.feat, stage_nbrs[s], pb.mask))
        return self.head(pb.feat)
