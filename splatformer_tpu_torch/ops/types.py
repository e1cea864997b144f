"""Core types of the rasterizer (port of splatformer_tpu/ops/types.py).

Every tensor is static-shape; the live scene size is carried by an explicit
validity ``mask``. There is no ``use_pallas`` switch: the device of the
tensors picks the path (CUDA kernels on the card, plain PyTorch on the CPU).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Camera:
    """Pinhole camera(s), OpenGL/Blender ``c2w`` (x right, y up, z back).

    A batch of V cameras has ``c2w`` (V, 3, 4) and intrinsics (V,);
    ``width``/``height`` are python ints shared by the batch."""

    c2w: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def select(self, i: int) -> "Camera":
        """View ``i`` as a batch of one."""
        return self.replace(c2w=self.c2w[i:i + 1], fx=self.fx[i:i + 1],
                            fy=self.fy[i:i + 1], cx=self.cx[i:i + 1],
                            cy=self.cy[i:i + 1])


@dataclass
class GaussianScene:
    """Raw (pre-activation) 3D Gaussian parameters, padded to a static size:
    means (N, 3), log-scales (N, 3), wxyz quats (N, 4), opacity logits
    (N, 1), features_dc (N, 3), features_rest (N, S, 3), mask (N,) bool."""

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    features_dc: torch.Tensor
    features_rest: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None

    @property
    def num_points(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        if self.features_rest is None or self.features_rest.shape[1] == 0:
            return 0
        num_bases = 1 + self.features_rest.shape[1]
        deg = int(round(num_bases ** 0.5)) - 1
        if (deg + 1) ** 2 != num_bases:
            raise ValueError(f"features_rest holds {num_bases - 1} SH bases")
        return deg

    def valid_mask(self) -> torch.Tensor:
        if self.mask is None:
            return torch.ones(self.num_points, dtype=torch.bool,
                              device=self.means.device)
        return self.mask

    def replace(self, **kw) -> "GaussianScene":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterization configuration (defaults of the JAX package).

    ``max_intersects`` is the (gaussian, tile) pair budget per view;
    ``tiles_per_gauss`` caps the tiles one Gaussian may cover; ``tiers``
    (tier1_slots, tier2_k, tier2_slots, tier3_k) sizes the binning's tiered
    expansion, None = auto from the image area (binning.auto_tiers). Pairs
    lost to either cap are counted in ``num_dropped``."""

    tile_size: int = 16
    max_intersects: int = 2 ** 18
    tiles_per_gauss: int = 64
    clip_thresh: float = 0.01
    alpha_threshold: float = 1.0 / 255.0
    transmittance_eps: float = 1e-4
    max_alpha: float = 0.999
    tiers: Optional[tuple] = None
