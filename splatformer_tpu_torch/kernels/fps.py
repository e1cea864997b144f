"""F1, farthest-point sampling of one point cloud in one launch: the CUDA
kernel's wrapper.

It replaces no TPU kernel: the JAX package runs FPS as a ``lax.scan`` in
XLA (splatformer_tpu/ops/downsample.py). In PyTorch the scan is a host loop
of ~6 launches a pick, ~211k launches at 100,352 slots and ratio 0.35. The
kernel (csrc/fps.cu) makes all m picks in one launch of one thread-block
cluster; its header says what bounds it and how each step stays on chip.
Its plain version is ops/downsample.py:furthest_point_sampling_plain, whose
picks it repeats bit for bit on the card: the same float32 operations in
PyTorch's CUDA sum order, ``torch.minimum``'s NaN and the first index on
ties of ``argmax``.
"""
from __future__ import annotations

import ctypes

import torch

from splatformer_tpu_torch.kernels import LAUNCHES
from splatformer_tpu_torch.kernels.build import load

# csrc/fps.cu's shape: one cluster of 16 CTAs (the non-portable size) x
# 1024 threads x at most 8 points a thread
CLUSTER, THREADS, POINTS_PER_THREAD = 16, 1024, 8
MAX_POINTS = CLUSTER * THREADS * POINTS_PER_THREAD   # 131,072 a launch


def _library() -> ctypes.CDLL:
    lib = load("fps")
    fn = lib.fps_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def furthest_point_sampling_kernel(coord: torch.Tensor, mask: torch.Tensor,
                                   m: int) -> torch.Tensor:
    """(N, 3) float32 ``coord`` and (N,) bool ``mask`` on a CUDA device ->
    (m,) int64 picks, by one launch of one cluster of CLUSTER CTAs. Raises
    on any other input, and above MAX_POINTS points."""
    n = coord.shape[0] if coord.ndim == 2 else -1
    if coord.device.type != "cuda" or mask.device != coord.device:
        raise ValueError(f"the FPS kernel takes CUDA tensors on one device, "
                         f"got {coord.device} and {mask.device}")
    if coord.dtype != torch.float32 or tuple(coord.shape) != (n, 3):
        raise ValueError(f"coord must be (N, 3) float32, got "
                         f"{tuple(coord.shape)} {coord.dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be ({n},) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if n > MAX_POINTS:
        raise ValueError(f"{n} points exceed the FPS kernel's limit of "
                         f"{MAX_POINTS} ({CLUSTER} CTAs x {THREADS} threads "
                         f"x {POINTS_PER_THREAD} points)")
    if m < 1 or n < 1:
        raise ValueError(f"FPS needs a point and a pick, got N = {n}, "
                         f"m = {m}")
    coord, mask = coord.contiguous(), mask.contiguous()
    picks = torch.empty((m,), dtype=torch.int64, device=coord.device)
    stream = torch.cuda.current_stream(coord.device).cuda_stream
    err = _library().fps_launch(coord.data_ptr(), mask.data_ptr(), n, m,
                                picks.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fps launch failed: cudaError {err}")
    LAUNCHES["fps"] += 1
    return picks
