"""LPIPS perceptual distance with the VGG16 backbone (port of
splatformer_tpu/models/lpips.py).

Inputs in [0, 1] -> [-1, 1] -> per-channel shift/scale -> VGG16 conv
features at relu{1_2, 2_2, 3_3, 4_3, 5_3} -> unit-normalised over channels
-> squared difference -> non-negative per-channel 'lin' weights -> spatial
mean -> summed over the five layers. The convolutions are plain
``F.conv2d`` (the JAX package leaves them to XLA; no kernel of its own),
in full float32: the package keeps cuDNN's TF32 off.

Weights come from the JAX package's npz layout (``load_lpips_params``):
keys ``vgg/conv{s}_{c}/{kernel,bias}`` with HWIO kernels and ``lin{0..4}``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from splatformer_tpu_torch.data.convert import lpips_state_dict_from_npz
from splatformer_tpu_torch.device import resolve_device

# VGG16: (out_channels, convs) per stage; features tapped after each stage
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def expected_weight_shapes() -> Dict[str, tuple]:
    """The npz layout contract: key -> shape (kernels HWIO)."""
    shapes = {}
    in_ch = 3
    for si, (ch, n_convs) in enumerate(VGG_STAGES):
        for ci in range(n_convs):
            shapes[f"vgg/conv{si}_{ci}/kernel"] = (3, 3, in_ch, ch)
            shapes[f"vgg/conv{si}_{ci}/bias"] = (ch,)
            in_ch = ch
        shapes[f"lin{si}"] = (ch,)
    return shapes


class LPIPS(nn.Module):
    """Call with two (N, H, W, 3) images in [0, 1]; returns (N,) distances.
    Parameters: ``conv{s}_{c}`` Conv2d layers (OIHW) and ``lin{s}``."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for si, (ch, n_convs) in enumerate(VGG_STAGES):
            for ci in range(n_convs):
                self.add_module(f"conv{si}_{ci}",
                                nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch
            self.register_parameter(f"lin{si}",
                                    nn.Parameter(torch.ones(ch)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def features(self, x: torch.Tensor):
        feats = []
        for si, (_, n_convs) in enumerate(VGG_STAGES):
            for ci in range(n_convs):
                x = F.relu(self.get_submodule(f"conv{si}_{ci}")(x))
            feats.append(x)
            if si < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        def prep(x):
            x = 2.0 * x.permute(0, 3, 1, 2) - 1.0
            return (x - self.shift) / self.scale

        total = 0.0
        for si, (a, b) in enumerate(zip(self.features(prep(img1)),
                                        self.features(prep(img2)))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            w = torch.abs(getattr(self, f"lin{si}"))
            d = torch.sum((a - b) ** 2 * w[None, :, None, None], dim=1)
            total = total + torch.mean(d, dim=(1, 2))
        return total


def load_lpips_params(path: Optional[str]
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """The LPIPS state_dict from an npz in the JAX package's layout, or None
    only when no file exists at ``path`` (L1-only training). A file that
    exists but breaks the layout contract (a missing key, a wrong shape,
    a non-finite value) raises ValueError."""
    if not path or not os.path.exists(path):
        return None
    data = np.load(path)
    bad = []
    for key, shape in expected_weight_shapes().items():
        if key not in data:
            bad.append(f"missing key {key}")
        elif tuple(data[key].shape) != shape:
            bad.append(f"{key}: shape {tuple(data[key].shape)} != {shape}")
        elif not np.isfinite(data[key]).all():
            bad.append(f"{key}: non-finite values")
    if bad:
        raise ValueError(f"LPIPS weights file {path} violates the layout "
                         "contract: " + "; ".join(bad))
    return lpips_state_dict_from_npz(data)


def make_lpips_fn(weights_path: Optional[str] = None, device: str = "cuda"
                  ) -> Optional[LPIPS]:
    """An eval-mode LPIPS on ``device`` with the weights at
    ``weights_path``, frozen, called as (img1, img2) -> (N,); None when no
    weights file exists there (the caller then skips LPIPS)."""
    sd = load_lpips_params(weights_path) if weights_path else None
    if sd is None:
        return None
    model = LPIPS()
    model.load_state_dict(sd)
    return model.requires_grad_(False).eval().to(resolve_device(device))


def write_synthetic_weights(path: str, seed: int = 42) -> None:
    """Write seeded random-feature LPIPS weights in the JAX package's npz
    layout (port of scripts/make_synthetic_lpips_weights.py ``generate``,
    the same numpy stream): He-normal VGG kernels, zero biases, and lin
    heads of 1/C scaled so that a canonical pair, a uniform 64^2 image and
    its copy with 0.1-sigma noise (clipped; ``default_rng(0)``), lies 0.2
    apart, the scale of the real metric. Not the published LPIPS: numbers
    from these weights compare only with runs on the same weights."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for key, shape in expected_weight_shapes().items():
        if key.endswith("/kernel"):
            fan_in = 9 * shape[2]
            arrays[key] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                     shape).astype(np.float32)
        elif key.endswith("/bias"):
            arrays[key] = np.zeros(shape, np.float32)
        else:
            arrays[key] = np.full(shape, 1.0 / shape[0], np.float32)
    model = LPIPS()
    model.load_state_dict(lpips_state_dict_from_npz(arrays))
    r = np.random.default_rng(0)
    img = torch.as_tensor(r.uniform(size=(1, 64, 64, 3)), dtype=torch.float32)
    noise = torch.as_tensor(r.normal(size=(1, 64, 64, 3)), dtype=torch.float32)
    with torch.no_grad():
        d = float(model(img, torch.clamp(img + 0.1 * noise, 0, 1))[0])
    gain = 0.2 / max(d, 1e-9)
    for si in range(len(VGG_STAGES)):
        arrays[f"lin{si}"] *= gain
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
