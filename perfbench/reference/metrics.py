"""Image quality metrics (a frozen copy of splatformer_tpu_torch/training/metrics.py):
PSNR over per-image MSE; SSIM with an 11x11 sigma-1.5 Gaussian window, zero
'same' padding, C1 = 0.01^2, C2 = 0.03^2, averaged per image. Images are (N, H, W, C) in [0, 1]. The window conv runs
in full float32 (steps.full_float32): the conv(x^2) - mu^2 variance cancels
catastrophically in reduced precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) pairs -> (N,) PSNR in dB (max value 1.0)."""
    mse = torch.mean((img1 - img2) ** 2, dim=(1, 2, 3))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-20)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - size // 2) ** 2) / (2.0 * sigma ** 2))
                      for x in range(size)], dtype=torch.float32,
                     device=device)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11
         ) -> torch.Tensor:
    """(N, H, W, C) pairs -> (N,) mean SSIM (depthwise window conv)."""
    c = img1.shape[-1]
    win = _gaussian_window(window_size, 1.5, img1.device).to(img1.dtype)
    win = win[None, None].expand(c, 1, window_size, window_size)

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win, padding=window_size // 2,
                        groups=c)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * s12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return torch.mean(ssim_map, dim=(1, 2, 3))
