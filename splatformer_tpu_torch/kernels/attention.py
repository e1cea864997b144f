"""K3, attention within fixed-size patches: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd function over the two.

Replace the Pallas TPU flash-attention kernel that the JAX package calls at
splatformer_tpu/models/ptv3.py (``jax.experimental.pallas.ops.tpu.
flash_attention``): ``_flash_attention_kernel_single_batch`` forward, and
``_flash_attention_dkv_kernel`` / ``_flash_attention_dq_kernel`` backward.
The kernel sources are csrc/attention_fwd.cu and csrc/attention_bwd.cu,
whose headers state what bounds each kernel on Hopper and what its design
does about it. Every kernel runs on the tensor cores (mma.sync,
cp.async-staged tiles): bfloat16 directly, float32 as split-TF32 products
(each operand split into two TF32 halves, three products a product, which
keeps float32 accuracy), the forward in one pass and the backward in a dQ
pass and a dK/dV pass.

Layout (B, H, K, d) as the JAX kernel's: B patches, H heads, K tokens a
patch, head width d. Semantics kept from the JAX kernel: logits s = (q k^T)
* scale in float32, the unnormalised probabilities cast to v's dtype before
P V, float32 accumulation, the output in q's dtype, and the log-sum-exp
``lse`` (B, H, K) in float32 for the backward. The backward recomputes P =
exp(s - lse), forms D = rowsum(dO o O) and dS = (dP - D) o P * scale, and
casts P and dS to the cotangent's dtype before their products, as the JAX
kernel does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from splatformer_tpu_torch.kernels import LAUNCHES
from splatformer_tpu_torch.kernels.build import load

HEAD_DIMS = (16, 24, 32)   # the head widths of PTv3-base; the kernels' D
BLOCK = 64                 # queries (and keys) per CTA of the kernels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535        # B * H is the kernels' grid y


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, K, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must be all float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v lie on different devices")
    b, h, seq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of {HEAD_DIMS}")
    if seq % BLOCK:
        raise ValueError(f"patch of {seq} tokens is not a multiple of {BLOCK}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"{b} x {h} patch heads exceed one launch")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address: the tensor-core
    kernels of both types stage tiles with 16-byte ``cp.async``."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _library_fwd() -> ctypes.CDLL:
    lib = load("attention_fwd")
    fn = lib.attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (o (B, H, K, d) in q's dtype, lse (B, H, K) float32). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention_fwd for device {q.device}")
    b, h, seq, d = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, seq), dtype=torch.float32, device=q.device)
    err = _library_fwd().attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, seq, d, _DTYPE_CODES[q.dtype], scale,
        _stream(q))
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    LAUNCHES["attention_fwd"] += 1
    return o, lse


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _library_bwd() -> ctypes.CDLL:
    lib = load("attention_bwd")
    fn = lib.attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check_saved(q: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                 do: torch.Tensor) -> None:
    for name, x, dtype, shape in (("o", o, q.dtype, q.shape),
                                  ("do", do, q.dtype, q.shape),
                                  ("lse", lse, torch.float32, q.shape[:3])):
        if x.dtype != dtype or x.shape != shape or x.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dq, dk, dv), each in its input's dtype, given the forward's ``o``
    and ``lse`` and the cotangent ``do``. CUDA tensors launch the kernels, a
    dQ pass then a dK/dV pass (or raise); CPU tensors take the plain
    version."""
    _check(q, k, v)
    _check_saved(q, o, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention_bwd for device {q.device}")
    b, h, seq, d = q.shape
    q, k, v, o, lse, do = (_aligned(x) for x in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((b, h, seq), dtype=torch.float32, device=q.device)
    err = _library_bwd().attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, seq, d, _DTYPE_CODES[q.dtype],
        scale, _stream(q))
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {err}")
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' function in plain PyTorch, on any device."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    di = torch.sum(o.float() * dof, dim=-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (dp - di) * p * scale
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), qf)
    dq = torch.matmul(ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """softmax(scale q k^T) v over (B, H, K, d): K3 forward, K3 backward.
    Keeps only ``o`` and the (B, H, K) log-sum-exp for the backward, never
    the (B, H, K, K) probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None
