"""LPIPS perceptual distance with the VGG16 backbone (a frozen copy of
splatformer_tpu_torch/models/lpips.py).

Inputs in [0, 1] -> [-1, 1] -> per-channel shift/scale -> VGG16 conv
features at relu{1_2, 2_2, 3_3, 4_3, 5_3} -> unit-normalised over channels
-> squared difference -> non-negative per-channel 'lin' weights -> spatial
mean -> summed over the five layers. The convolutions are plain
``F.conv2d`` (the JAX package leaves them to XLA; no kernel of its own),
in full float32 (steps.full_float32). The harness loads the seeded
weights (lib/weights.py:lpips_state).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


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
