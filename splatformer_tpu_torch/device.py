"""Device selection for the port's entry points.

Entry points default to the card. On a machine without one they raise
unless the caller asks for the CPU explicitly (as the tests do), so a run
meant for the GPU never falls back to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device
