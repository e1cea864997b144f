"""FeaturePredictor: Gaussian-attribute refinement heads over the PTv3
backbone (port of splatformer_tpu/models/feature_predictor.py).

Input feature = the per-Gaussian attributes concatenated in the configured
order; PTv3 over the means voxelised at grid_resolution; optional concat of
the input features onto the backbone output; one ReLU MLP head per output
attribute; residual ('res': in + act(head)) or direct ('dc') outputs;
attributes not predicted are copied through, padded slots untouched.
In training the four serialization orders are shuffled (a permutation
drawn from the caller's generator, or given), DropPath draws from the same
generator, and ``compute_dtype`` (bfloat16) applies inside the backbone's
blocks; the heads stay float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.models.point import make_point_batch
from splatformer_tpu_torch.models.ptv3 import (Block, PointTransformerV3,
                                               merging_requested)
from splatformer_tpu_torch.ops.serialization import ORDERS
from splatformer_tpu_torch.ops.types import GaussianScene

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
    ):
        super().__init__()
        if output_features_type not in ("res", "dc"):
            raise ValueError(f"output_features_type {output_features_type!r}")
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
        self.backbone = PointTransformerV3(in_channels=in_ch,
                                           compute_dtype=compute_dtype,
                                           **(backbone_kwargs or {}))
        head_in = self.backbone.out_channels + (in_ch if input_feat_to_mlp
                                                else 0)
        for f in self.output_features:
            self.add_module(f"head_{f}", OutputHead(
                head_in, ch[f], output_head_nlayer, output_head_width))

    def forward(self, scene: GaussianScene,
                generator: Optional[torch.Generator] = None,
                order_perm: Optional[torch.Tensor] = None) -> GaussianScene:
        """Refine ``scene``. In training, ``order_perm`` (a permutation of
        the 4 orders) fixes the order shuffle, else it is drawn from
        ``generator``, which DropPath also draws from; both are ignored in
        evaluation."""
        mask = scene.valid_mask()
        n = scene.num_points
        feat = torch.cat([getattr(scene, k).reshape(n, -1)
                          for k in self.input_features], dim=1)
        feat = torch.where(mask[:, None], feat, torch.zeros_like(feat))
        perm = None
        if self.training:
            perm = order_perm
            if perm is None:
                dev = generator.device if generator is not None else None
                perm = torch.randperm(len(ORDERS), generator=generator,
                                      device=dev)
            perm = perm.to(device=mask.device, dtype=torch.int64)
        pb = make_point_batch(scene.means, feat, mask,
                              grid_resolution=self.grid_resolution,
                              order_shuffle=perm)
        y = self.backbone(pb, generator)
        if self.input_feat_to_mlp:
            y = torch.cat([y, feat], dim=1)

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


@torch.no_grad()
def init_weights(model: FeaturePredictor, generator: torch.Generator,
                 zeroinit: bool = True, head_final_scale: float = 1.0) -> None:
    """Seeded initialisation: every Linear and xCPE kernel normal with std
    1/sqrt(fan_in), biases zero, norms at identity; each head's final layer
    zero (``zeroinit``: step 0 is an identity refinement) or scaled by
    ``head_final_scale``. Drawn on the CPU, so a seed gives the same
    weights on every device."""
    def normal_(param, fan_in):
        draw = torch.randn(param.shape, generator=generator)
        param.copy_(draw * fan_in ** -0.5)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            normal_(mod.weight, mod.in_features)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Block):
            k, cin, _ = mod.cpe_conv_kernel.shape
            normal_(mod.cpe_conv_kernel, k * cin)
            mod.cpe_conv_bias.zero_()
    for f in model.output_features:
        last = model.get_submodule(f"head_{f}").linears[-1]
        if zeroinit:
            last.weight.zero_()
        else:
            last.weight.mul_(head_final_scale)


def build_feature_predictor(cfg: ModelConfig, device: str = "cuda",
                            seed: int = 0, head_final_scale: float = 1.0,
                            compute_dtype: Optional[str] = None
                            ) -> FeaturePredictor:
    """FeaturePredictor from a ModelConfig, seeded, in eval mode, on
    ``device``; ``compute_dtype="bfloat16"`` is the blocks' dtype in
    training. Parts of the config the port does not run yet raise."""
    device = resolve_device(device)
    b = cfg.backbone
    unported = []
    if cfg.backbone_type != "PT":
        unported.append(f"backbone_type={cfg.backbone_type!r}")
    if cfg.output_head_type != "mlp-relu":
        unported.append(f"output_head_type={cfg.output_head_type!r}")
    if b.turn_off_bn:
        unported.append("turn_off_bn")
    if b.embedding_type != "MLP":
        unported.append(f"embedding_type={b.embedding_type!r}")
    if merging_requested(cfg.additional_info):
        unported.append(f"token merging {cfg.additional_info.get('tome')!r}")
    if cfg.additional_info.get("downsample"):
        unported.append("input downsampling")
    if unported:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + ", ".join(unported))
    model = FeaturePredictor(
        sh_degree=cfg.sh_degree, input_features=cfg.input_features,
        output_features=cfg.output_features,
        input_feat_to_mlp=cfg.input_feat_to_mlp,
        output_head_nlayer=cfg.output_head_nlayer,
        output_head_width=cfg.output_head_width,
        output_features_type=cfg.output_features_type,
        res_feature_activation=dict(cfg.res_feature_activation),
        max_scale_normalized=cfg.max_scale_normalized,
        grid_resolution=cfg.grid_resolution,
        backbone_kwargs=b.backbone_kwargs(),
        compute_dtype=(None if compute_dtype in (None, "float32")
                       else getattr(torch, compute_dtype)))
    init_weights(model, torch.Generator().manual_seed(seed),
                 zeroinit=cfg.zeroinit, head_final_scale=head_final_scale)
    return model.eval().to(device)
