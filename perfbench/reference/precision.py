"""The control's lower precision: the reference's matrix products and
convolutions with their operands rounded to TF32 (10 mantissa bits; on the
card, TF32 itself through torch's switches) or to scaled float8 e4m3
(per-tensor scale amax / 448, as fp8 training recipes scale), by a
dispatch mode that rounds the operands of each product it sees."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
_FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, in x's dtype."""
    if not x.is_floating_point():
        return x
    scale = torch.clamp(x.detach().abs().amax().float(), min=1e-30) / _FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


# product -> positions of the operands to round
_OPERANDS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
             aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2),
             aten.convolution.default: (0, 1)}


class OperandRounding(TorchDispatchMode):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        where = _OPERANDS.get(func)
        if where:
            args = tuple(self.fn(a) if i in where else a
                         for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def lower(mode: Optional[str], device) -> Iterator[None]:
    """``None``: as stated; ``tf32``: TF32 products (the card's TF32
    switches on CUDA, the rounding elsewhere); ``fp8``: scaled e4m3
    operands."""
    if mode is None:
        yield
        return
    if mode == "tf32" and torch.device(device).type == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        return
    fn = {"tf32": round_tf32, "fp8": round_fp8}[mode]
    with OperandRounding(fn):
        yield
