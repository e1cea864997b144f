"""FeaturePredictor: Gaussian-attribute refinement heads over PTv3 (a
frozen copy of splatformer_tpu_torch/models/feature_predictor.py without
SpUNet and the process group).

Input feature = the per-Gaussian attributes concatenated in the configured
order; PTv3 over the means voxelised at grid_resolution; the input
features concatenated onto the backbone output; one ReLU MLP head per
output attribute; residual ('res': in + act(head)) or direct ('dc')
outputs; padded slots untouched. Training shuffles PTv3's four
serialization orders with a permutation drawn from the caller's generator,
which DropPath also draws from; ``compute_dtype`` applies inside PTv3's
blocks, the heads stay float32.

With ``additional_info["downsample"]`` (fps, voxel, random) the backbone
runs on the reduced set of downsample.py and its outputs are mapped back to
every point before the heads, which see the full-resolution input
features; training draws random keep's scores from the caller's generator
before the order shuffle, evaluation from a CPU generator seeded 0.
``reduce`` gives the reduced set alone, and ``forward``'s ``reduced`` runs
the backbone on one made elsewhere in place of its own."""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.downsample import downsample_dispatch, reduce
from perfbench.reference.point import make_point_batch
from perfbench.reference.ptv3 import PointTransformerV3
from perfbench.reference import merging
from perfbench.reference.serialization import ORDERS
from perfbench.reference.types import GaussianScene

ALL_FEATURES = ("means", "features_dc", "features_rest", "opacities",
                "scales", "quats")

_ACTIVATIONS = {"tanh": torch.tanh, "identity": lambda x: x,
                "sigmoid": torch.sigmoid}


def feature_channels(sh_degree: int) -> Dict[str, int]:
    return {"means": 3, "features_dc": 3,
            "features_rest": ((sh_degree + 1) ** 2 - 1) * 3,
            "opacities": 1, "scales": 3, "quats": 4}


class OutputHead(nn.Module):
    """(nlayer - 1) x [Linear(width) + ReLU] + Linear(out)."""

    def __init__(self, in_dim: int, out_dim: int, nlayer: int, width: int):
        super().__init__()
        dims = [in_dim] + [width] * (nlayer - 1) + [out_dim]
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.linears[:-1]:
            x = F.relu(lin(x))
        return self.linears[-1](x)


class FeaturePredictor(nn.Module):
    def __init__(
        self,
        backbone_type: str = "PT",
        sh_degree: int = 1,
        input_features: Sequence[str] = ALL_FEATURES,
        output_features: Sequence[str] = ALL_FEATURES,
        input_feat_to_mlp: bool = True,
        output_head_nlayer: int = 4,
        output_head_width: int = 128,
        output_features_type: str = "res",
        res_feature_activation: Optional[Dict[str, str]] = None,
        max_scale_normalized: float = 1e-2,
        grid_resolution: int = 384,
        backbone_kwargs: Optional[Dict[str, Any]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        additional_info: Optional[Dict[str, Any]] = None,
    ):
        super().__init__()
        if output_features_type not in ("res", "dc"):
            raise ValueError(f"output_features_type {output_features_type!r}")
        self.backbone_type = backbone_type
        self.additional_info = dict(additional_info or {})
        self.sh_degree = sh_degree
        self.input_features = tuple(input_features)
        self.output_features = tuple(output_features)
        self.input_feat_to_mlp = input_feat_to_mlp
        self.output_features_type = output_features_type
        self.activation = res_feature_activation or {"means": "tanh"}
        self.max_scale_normalized = max_scale_normalized
        self.grid_resolution = grid_resolution
        ch = feature_channels(sh_degree)
        in_ch = sum(ch[k] for k in self.input_features)
        if backbone_type != "PT":
            raise NotImplementedError(f"backbone_type {backbone_type!r}")
        self.backbone = PointTransformerV3(
            in_channels=in_ch, compute_dtype=compute_dtype,
            additional_info=self.additional_info, **(backbone_kwargs or {}))
        head_in = self.backbone.out_channels + (in_ch if input_feat_to_mlp
                                                else 0)
        for f in self.output_features:
            self.add_module(f"head_{f}", OutputHead(
                head_in, ch[f], output_head_nlayer, output_head_width))

    def _input(self, scene: GaussianScene):
        """(mask, the input features of the live points, zero elsewhere)."""
        mask = scene.valid_mask()
        n = scene.num_points
        feat = torch.cat([getattr(scene, k).reshape(n, -1)
                          for k in self.input_features], dim=1)
        return mask, torch.where(mask[:, None], feat, torch.zeros_like(feat))

    def reduce(self, scene: GaussianScene):
        """downsample.py:reduce of the scene in evaluation: (coord, feat,
        mask, index) of the reduced set the backbone would run on."""
        mask, feat = self._input(scene)
        info = self.additional_info
        return reduce(info["downsample"], info, scene.means, feat, mask)

    def forward(self, scene: GaussianScene,
                generator: Optional[torch.Generator] = None,
                order_perm: Optional[torch.Tensor] = None,
                merge_scores: Optional[Iterable[torch.Tensor]] = None,
                reduced: Optional[Sequence[torch.Tensor]] = None
                ) -> GaussianScene:
        """Refine ``scene``. In training, ``order_perm`` (a permutation of
        the 4 orders) fixes PTv3's order shuffle, else it is drawn from
        ``generator``, which DropPath also draws from, as do random_patch
        merging's block scores unless ``merge_scores`` gives them. With
        input downsampling, ``reduced`` (a ``reduce`` result) takes the
        place of the reduced set this call would make."""
        mask, feat = self._input(scene)
        n = scene.num_points
        dev = mask.device

        gdev = generator.device if generator is not None else None

        def draw(shape):
            return torch.rand(tuple(shape), generator=generator,
                              device=gdev).to(dev)

        info = self.additional_info
        coord, feat_full, mask_ds, up = scene.means, feat, mask, None
        if info.get("downsample"):
            coord, feat, mask_ds, up = downsample_dispatch(
                info["downsample"], info, coord, feat, mask,
                draw if self.training else None, reduced)

        perm = None
        if self.training:
            perm = order_perm
            if perm is None:
                perm = torch.randperm(len(ORDERS), generator=generator,
                                      device=gdev)
            perm = perm.to(device=dev, dtype=torch.int64)
        pb = make_point_batch(coord, feat, mask_ds,
                              grid_resolution=self.grid_resolution,
                              order_shuffle=perm)
        uniform = None
        if self.training and merging.needs_rng(info.get("tome"), info):
            if merge_scores is not None:
                scores = iter(merge_scores)
                uniform = lambda shape: next(scores)  # noqa: E731
            else:
                uniform = draw
        y = self.backbone(pb, generator, uniform)
        if up is not None:
            y = up(y)  # the reduced set's outputs back on every point
        if self.input_feat_to_mlp:
            y = torch.cat([y, feat_full], dim=1)

        out = {}
        for f in self.output_features:
            o = self.get_submodule(f"head_{f}")(y)
            if self.output_features_type == "dc":
                if f == "scales" and self.max_scale_normalized > 0:
                    o = -F.relu(o) + math.log(self.max_scale_normalized)
            else:
                act = _ACTIVATIONS[self.activation.get(f, "identity").lower()]
                o = act(o)
            if f == "features_rest":
                o = o.reshape(n, -1, 3)
            out[f] = o if self.output_features_type == "dc" \
                else getattr(scene, f) + o

        refined = {}
        for key in ALL_FEATURES:
            if key in out and not (self.sh_degree == 0
                                   and key == "features_rest"):
                m = mask.reshape((-1,) + (1,) * (out[key].ndim - 1))
                refined[key] = torch.where(m, out[key], getattr(scene, key))
        return scene.replace(**refined)


