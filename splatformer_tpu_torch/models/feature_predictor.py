"""FeaturePredictor: Gaussian-attribute refinement heads over a point
backbone (port of splatformer_tpu/models/feature_predictor.py).

Input feature = the per-Gaussian attributes concatenated in the configured
order; the backbone (PTv3, or SpUNet for ``backbone_type="SP"``) over the
means voxelised at grid_resolution; optional concat of the input features
onto the backbone output; one ReLU MLP head per output attribute; residual
('res': in + act(head)) or direct ('dc') outputs; attributes not predicted
are copied through, padded slots untouched.

With ``additional_info["downsample"]`` (fps, voxel, random) the backbone
runs on a reduced point set (ops/downsample.py) and its outputs are mapped
back to every point before the heads, which still see the full-resolution
input features. Token merging (``additional_info["tome"]``) runs inside
PTv3's blocks (models/ptv3.py).

In training the four serialization orders of PTv3 are shuffled (a
permutation drawn from the caller's generator, or given), DropPath draws
from the same generator, as do random_patch merging and random
downsampling (or they take injected draws), and ``compute_dtype``
(bfloat16) applies inside PTv3's blocks; the heads stay float32. With
``bn_group`` (a torch.distributed process group) every masked BatchNorm
of the backbone takes its training statistics over the group (the JAX
package's ``bn_axis_name``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.configs.model_ptv3_base import ModelConfig
from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.models.point import make_point_batch
from splatformer_tpu_torch.models.ptv3 import PointTransformerV3
from splatformer_tpu_torch.models.spunet import SpUNet
from splatformer_tpu_torch.ops import merging
from splatformer_tpu_torch.ops.downsample import downsample_dispatch
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
        bn_group=None,
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
        if backbone_type == "PT":
            self.backbone = PointTransformerV3(
                in_channels=in_ch, compute_dtype=compute_dtype,
                additional_info=self.additional_info, bn_group=bn_group,
                **(backbone_kwargs or {}))
        elif backbone_type == "SP":
            self.backbone = SpUNet(in_channels=in_ch, bn_group=bn_group,
                                   **(backbone_kwargs or {}))
        else:
            raise NotImplementedError(f"backbone_type {backbone_type!r}")
        head_in = self.backbone.out_channels + (in_ch if input_feat_to_mlp
                                                else 0)
        for f in self.output_features:
            self.add_module(f"head_{f}", OutputHead(
                head_in, ch[f], output_head_nlayer, output_head_width))

    def forward(self, scene: GaussianScene,
                generator: Optional[torch.Generator] = None,
                order_perm: Optional[torch.Tensor] = None,
                merge_scores: Optional[Iterable[torch.Tensor]] = None,
                downsample_scores: Optional[torch.Tensor] = None,
                diagnostics: Optional[Dict[str, Any]] = None
                ) -> GaussianScene:
        """Refine ``scene``. In training, ``order_perm`` (a permutation of
        the 4 orders) fixes PTv3's order shuffle, else it is drawn from
        ``generator``, which DropPath also draws from; random_patch merging
        draws its block scores from it too, or takes them in call order
        from ``merge_scores`` (one (B, H, blocks) tensor a merge: each
        block's attention, then its MLP). ``downsample_scores`` (N,) fixes
        random downsampling's scores in either mode; without it training
        draws them from ``generator``, evaluation from a CPU generator
        seeded 0. Evaluation draws nothing else. ``diagnostics``, when
        given, is filled with PTv3's (models/ptv3.py; with downsampling,
        those of the reduced set); SpUNet's are empty."""
        with tracing.span("refine"):
            return self._refine(scene, generator, order_perm, merge_scores,
                                downsample_scores, diagnostics)

    def _refine(self, scene, generator, order_perm, merge_scores,
                downsample_scores, diagnostics):
        mask = scene.valid_mask()
        n = scene.num_points
        dev = mask.device
        feat = torch.cat([getattr(scene, k).reshape(n, -1)
                          for k in self.input_features], dim=1)
        feat = torch.where(mask[:, None], feat, torch.zeros_like(feat))

        gdev = generator.device if generator is not None else None

        def draw(shape):
            return torch.rand(tuple(shape), generator=generator,
                              device=gdev).to(dev)

        info = self.additional_info
        coord, feat_full, mask_ds, up = scene.means, feat, mask, None
        if info.get("downsample"):
            uniform = ((lambda shape: downsample_scores)
                       if downsample_scores is not None
                       else draw if self.training else None)
            with tracing.span("refine.downsample"):
                coord, feat, mask_ds, up = downsample_dispatch(
                    info["downsample"], info, coord, feat, mask, uniform)

        perm = None
        if self.training and self.backbone_type == "PT":
            perm = order_perm
            if perm is None:
                perm = torch.randperm(len(ORDERS), generator=generator,
                                      device=gdev)
            perm = perm.to(device=dev, dtype=torch.int64)
        pb = make_point_batch(coord, feat, mask_ds,
                              grid_resolution=self.grid_resolution,
                              order_shuffle=perm)
        if self.backbone_type == "SP":
            y = self.backbone(pb)
        else:
            uniform = None
            if self.training and merging.needs_rng(info.get("tome"), info):
                if merge_scores is not None:
                    scores = iter(merge_scores)
                    uniform = lambda shape: next(scores)  # noqa: E731
                else:
                    uniform = draw
            y = self.backbone(pb, generator, uniform, diagnostics)
        with tracing.span("refine.heads"):
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
                    act = self.activation.get(f, "identity").lower()
                    o = _ACTIVATIONS[act](o)
                if f == "features_rest":
                    o = o.reshape(n, -1, 3)
                out[f] = o if self.output_features_type == "dc" \
                    else getattr(scene, f) + o

            refined = {}
            for key in ALL_FEATURES:
                if key in out and not (self.sh_degree == 0
                                       and key == "features_rest"):
                    m = mask.reshape((-1,) + (1,) * (out[key].ndim - 1))
                    refined[key] = torch.where(m, out[key],
                                               getattr(scene, key))
            return scene.replace(**refined)


@torch.no_grad()
def init_weights(model: FeaturePredictor, generator: torch.Generator,
                 zeroinit: bool = True, head_final_scale: float = 1.0) -> None:
    """Seeded initialisation: every Linear and every conv kernel (xCPE, the
    PT_embedding stem, SpUNet's blocks: parameters ``*_kernel`` of shape
    (27, Cin, Cout), with their ``*_bias``) normal with std 1/sqrt(fan_in),
    biases zero, norms at identity; each head's final layer
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
            continue
        for name, param in mod.named_parameters(recurse=False):
            if name.endswith("_kernel"):
                normal_(param, param.shape[0] * param.shape[1])
            elif name.endswith("_bias"):
                param.zero_()
    for f in model.output_features:
        last = model.get_submodule(f"head_{f}").linears[-1]
        if zeroinit:
            last.weight.zero_()
        else:
            last.weight.mul_(head_final_scale)


def build_feature_predictor(cfg: ModelConfig, device: str = "cuda",
                            seed: int = 0, head_final_scale: float = 1.0,
                            compute_dtype: Optional[str] = None,
                            bn_group=None) -> FeaturePredictor:
    """FeaturePredictor from a ModelConfig (any of the JAX package's model
    configs: PTv3 with its merging and downsampling options, or SpUNet),
    seeded, in eval mode, on ``device``; ``compute_dtype="bfloat16"`` is
    PTv3's block dtype in training; ``bn_group`` (a process group) syncs
    the training BatchNorm statistics over it (models/layers.py). Unknown
    values raise."""
    device = resolve_device(device)
    if cfg.output_head_type != "mlp-relu":
        raise NotImplementedError(
            f"output_head_type={cfg.output_head_type!r}: only 'mlp-relu' "
            "exists (the reference's sole head type)")
    b = cfg.backbone
    backbone_kwargs = (dict(cfg.sp_backbone) if cfg.backbone_type == "SP"
                       else b.backbone_kwargs())
    model = FeaturePredictor(
        backbone_type=cfg.backbone_type,
        sh_degree=cfg.sh_degree, input_features=cfg.input_features,
        output_features=cfg.output_features,
        input_feat_to_mlp=cfg.input_feat_to_mlp,
        output_head_nlayer=cfg.output_head_nlayer,
        output_head_width=cfg.output_head_width,
        output_features_type=cfg.output_features_type,
        res_feature_activation=dict(cfg.res_feature_activation),
        max_scale_normalized=cfg.max_scale_normalized,
        grid_resolution=cfg.grid_resolution,
        backbone_kwargs=backbone_kwargs,
        compute_dtype=(None if compute_dtype in (None, "float32")
                       else getattr(torch, compute_dtype)),
        additional_info=cfg.additional_info, bn_group=bn_group)
    init_weights(model, torch.Generator().manual_seed(seed),
                 zeroinit=cfg.zeroinit, head_final_scale=head_final_scale)
    return model.eval().to(device)
