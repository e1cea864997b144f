"""Shared layers (a frozen copy of splatformer_tpu_torch/models/layers.py
without the process group): masked BatchNorm, per-point DropPath, the block
MLP, and the compute-dtype Linear that the blocks use under bf16."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn



def linear(mod: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``mod(x)`` with input, weight and bias cast to ``dtype`` (flax Dense
    with ``dtype=``); the parameters stay float32."""
    if dtype is None:
        return mod(x)
    bias = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), bias)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the point axis (eps 1e-3, momentum 0.01 in torch's
    sense, as the reference's BatchNorm1d).

    Training normalises with the batch statistics of the VALID points
    (``mask``), computed in float32 whatever the input dtype: biased
    variance for normalising, unbiased for the running update, the count
    clamped at 1. Evaluation normalises with the running statistics.
    Parameters ``scale``/``bias`` and buffers ``mean``/``var`` keep the
    JAX package's names; the output has the input's dtype. ``off`` (the
    ``turn_off_bn`` configurations) makes it the identity, with no
    parameters or statistics.
"""

    def __init__(self, channels: int, eps: float = 1e-3,
                 momentum: float = 0.01, off: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.off = off
        if off:
            return
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.off:
            return x
        in_dtype = x.dtype
        x = x.to(torch.float32)
        if self.training:
            m = mask.to(torch.float32)[:, None]
            cnt = torch.clamp(torch.sum(m), min=1.0)
            mean = torch.sum(x * m, dim=0) / cnt
            var = torch.sum(torch.square(x - mean) * m, dim=0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                mom = self.momentum
                self.mean.copy_((1.0 - mom) * self.mean + mom * mean)
                self.var.copy_((1.0 - mom) * self.var + mom * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(in_dtype)


class DropPath(nn.Module):
    """Stochastic depth on the residual branch, per point: a Bernoulli keep
    mask over the first axis drawn from ``generator`` (on the input's
    device), the kept rows scaled by 1 / keep. The identity in evaluation
    or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        draw = torch.rand(shape, generator=generator, device=x.device)
        return x * (draw < keep).to(x.dtype) / keep


class Mlp(nn.Module):
    """Linear -> GELU (tanh approximation, as flax's nn.gelu) -> Linear, in
    ``dtype`` when one is given."""

    def __init__(self, channels: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = F.gelu(linear(self.fc1, x, dtype), approximate="tanh")
        return linear(self.fc2, h, dtype)
