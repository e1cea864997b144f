"""Shared layers (port of splatformer_tpu/models/layers.py, evaluation only):
masked BatchNorm, per-point DropPath, the block MLP.

Training-mode statistics and stochastic depth belong to the training
slice of the port (ROADMAP.md); here they raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the point axis (eps 1e-3, as the reference's
    BatchNorm1d). Evaluation normalises with the running statistics, so
    the validity mask, which only the batch statistics read, is not taken
    here; parameters ``scale``/``bias`` and buffers ``mean``/``var`` keep
    the JAX package's names."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "masked batch statistics come with the training slice "
                "(ROADMAP.md); call .eval()")
        y = (x - self.mean) * torch.rsqrt(self.var + self.eps)
        return y * self.scale + self.bias


class DropPath(nn.Module):
    """Stochastic depth on the residual branch; the identity in evaluation."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "stochastic depth comes with the training slice (ROADMAP.md)")
        return x


class Mlp(nn.Module):
    """Linear -> GELU (tanh approximation, as flax's nn.gelu) -> Linear."""

    def __init__(self, channels: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
