"""Weights made from the seed, on the device, in one draw: the same values
for every module that has the same parameter names and shapes, so the
program and the reference each load them without reading the other's.

FeaturePredictor (PTv3 and the heads): every 2-D ``weight`` and every
``*_kernel`` (27, Cin, Cout) normal with std 1/sqrt(fan_in), norms at the
identity (1-D ``weight`` and ``scale`` one, the rest zero), each head's
last layer scaled by ``head_final_scale`` (the port's ``init_weights``
with ``zeroinit`` off). LPIPS's VGG: He-normal kernels, zero biases, the
``lin`` heads 1/C."""
from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

import torch

_HEAD_LAST = re.compile(r"^head_\w+\.linears\.(\d+)\.weight$")


def _draw(shapes: Iterable[Tuple[str, torch.Size]], seed: int, device,
          salt: int) -> Tuple[torch.Tensor, int]:
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (2 ** 63))
    return torch.randn(total, generator=gen, device=device), total


def model_state(named_shapes: Dict[str, torch.Size], seed: int, device,
                head_final_scale: float, head_layers: int
                ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for a FeaturePredictor's parameters."""
    drawn = [(n, s) for n, s in sorted(named_shapes.items()) if len(s) >= 2]
    flat, _ = _draw(drawn, seed, device, 1)
    out, offset = {}, 0
    last = str(head_layers - 1)
    for name, shape in drawn:
        k = int(torch.Size(shape).numel())
        w = flat[offset:offset + k].view(shape)
        offset += k
        fan_in = (shape[0] * shape[1] if name.endswith("_kernel")
                  else shape[1])
        w = w * fan_in ** -0.5
        m = _HEAD_LAST.match(name)
        if m and m.group(1) == last:
            w = w * head_final_scale
        out[name] = w
    for name, shape in named_shapes.items():
        if len(shape) < 2:
            one = name.endswith(".weight") or name.endswith(".scale")
            out[name] = (torch.ones if one else torch.zeros)(
                shape, device=device)
    return out


def lpips_state(named_shapes: Dict[str, torch.Size], seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for an LPIPS module (Conv2d ``conv{s}_{c}`` OIHW and
    ``lin{s}``)."""
    drawn = [(n, s) for n, s in sorted(named_shapes.items()) if len(s) == 4]
    flat, _ = _draw(drawn, seed, device, 2)
    out, offset = {}, 0
    for name, shape in drawn:
        k = int(torch.Size(shape).numel())
        fan_in = shape[1] * shape[2] * shape[3]
        out[name] = flat[offset:offset + k].view(shape) * (2.0 / fan_in) ** 0.5
        offset += k
    for name, shape in named_shapes.items():
        if name.startswith("lin"):
            out[name] = torch.full(shape, 1.0 / shape[0], device=device)
        elif len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
    return out


@torch.no_grad()
def load(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``module``'s parameters; the names and shapes
    must be exactly the module's."""
    params = dict(module.named_parameters())
    if set(params) != set(state):
        raise ValueError("weights do not match the module: "
                         f"{sorted(set(params) ^ set(state))[:5]}")
    for name, p in params.items():
        p.copy_(state[name])


def shapes(module: torch.nn.Module) -> Dict[str, torch.Size]:
    return {n: p.shape for n, p in module.named_parameters()}
