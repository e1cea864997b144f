"""K1: tile alpha-compositing forward -- the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``fwd_kernel`` of
splatformer_tpu/ops/pallas/raster.py; the kernel source is
csrc/composite_fwd.cu, whose header states the contract, what bounds the
kernel on Hopper and what its design does about it.

Inputs: ``packed_t`` (16, budget) f32 depth-sorted entries, rows
[x, y, conic0-2, opacity, r, g, b, pad...]; ``tile_start`` (num_tiles + 1,)
int32 unpadded per-tile ranges over V flattened views. Outputs: ``out``
(num_tiles, 256, 4) f32 = [sum rgb, T] per pixel, and ``walked``
(num_tiles, 256) int32, the number of leading entries of its tile's range
each pixel consumed before it terminated (the range length if it never did).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from splatformer_tpu_torch.kernels import LAUNCHES
from splatformer_tpu_torch.kernels.build import load

TILE = 16
PIXELS = TILE * TILE
USED_ROWS = 9
PLAIN_CHUNK = 64  # entries per step of the plain version's walk


def _library() -> ctypes.CDLL:
    lib = load("composite_fwd")
    fn = lib.composite_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, ctypes.c_longlong, p, i, i, i, f, f, f, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check(packed_t: torch.Tensor, tile_start: torch.Tensor, tiles_x: int,
           tiles_img: int) -> int:
    if packed_t.dtype != torch.float32 or packed_t.ndim != 2 \
            or packed_t.shape[0] < USED_ROWS:
        raise ValueError(f"packed_t must be (16, budget) float32, got "
                         f"{tuple(packed_t.shape)} {packed_t.dtype}")
    if tile_start.dtype != torch.int32 or tile_start.ndim != 1:
        raise ValueError("tile_start must be a 1-D int32 tensor")
    if tile_start.device != packed_t.device:
        raise ValueError("packed_t and tile_start lie on different devices")
    num_tiles = tile_start.shape[0] - 1
    if tiles_x <= 0 or tiles_img <= 0 or tiles_img % tiles_x \
            or num_tiles % tiles_img:
        raise ValueError(f"{num_tiles} tiles do not make images of "
                         f"{tiles_img} tiles, {tiles_x} wide")
    return num_tiles


def composite_fwd(packed_t: torch.Tensor, tile_start: torch.Tensor,
                  tiles_x: int, tiles_img: int,
                  alpha_threshold: float = 1.0 / 255.0,
                  max_alpha: float = 0.999,
                  transmittance_eps: float = 1e-4,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out (num_tiles, 256, 4), walked (num_tiles, 256)). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    num_tiles = _check(packed_t, tile_start, tiles_x, tiles_img)
    if packed_t.device.type == "cpu":
        return composite_fwd_plain(packed_t, tile_start, tiles_x, tiles_img,
                                   alpha_threshold, max_alpha,
                                   transmittance_eps)
    if packed_t.device.type != "cuda":
        raise ValueError(f"no composite_fwd for device {packed_t.device}")
    packed_t = packed_t.contiguous()
    tile_start = tile_start.contiguous()
    out = torch.empty((num_tiles, PIXELS, 4), dtype=torch.float32,
                      device=packed_t.device)
    walked = torch.empty((num_tiles, PIXELS), dtype=torch.int32,
                         device=packed_t.device)
    stream = torch.cuda.current_stream(packed_t.device).cuda_stream
    err = _library().composite_fwd(
        packed_t.data_ptr(), packed_t.shape[1], tile_start.data_ptr(),
        num_tiles, tiles_x, tiles_img, alpha_threshold, max_alpha,
        transmittance_eps, out.data_ptr(), walked.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {err}")
    LAUNCHES["composite_fwd"] += 1
    return out, walked


def composite_fwd_plain(packed_t: torch.Tensor, tile_start: torch.Tensor,
                        tiles_x: int, tiles_img: int,
                        alpha_threshold: float = 1.0 / 255.0,
                        max_alpha: float = 0.999,
                        transmittance_eps: float = 1e-4,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device: vectorised over
    tiles and pixels, walking the entry ranges PLAIN_CHUNK entries at a time.
    sigma and alpha are computed for a whole chunk; the front-to-back
    recurrence then steps through the chunk's entries in order with the
    kernel's exact operations, so the two agree bit for bit where their
    exp agrees."""
    num_tiles = _check(packed_t, tile_start, tiles_x, tiles_img)
    dev = packed_t.device
    start = tile_start[:-1].to(torch.int64)
    length = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    local = torch.arange(num_tiles, device=dev) % tiles_img
    p = torch.arange(PIXELS, device=dev)
    px = ((local % tiles_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = (torch.div(local, tiles_x, rounding_mode="floor") * TILE)[:, None] \
        + torch.div(p, TILE, rounding_mode="floor")[None, :]
    px = px.to(torch.float32)[:, :, None]
    py = py.to(torch.float32)[:, :, None]

    rgb = torch.zeros((num_tiles, PIXELS, 3), dtype=torch.float32, device=dev)
    T = torch.ones((num_tiles, PIXELS), dtype=torch.float32, device=dev)
    walked = torch.zeros((num_tiles, PIXELS), dtype=torch.int32, device=dev)
    done = torch.zeros((num_tiles, PIXELS), dtype=torch.bool, device=dev)
    ent = packed_t[:USED_ROWS]
    max_len = int(length.max()) if num_tiles else 0
    for base in range(0, max_len, PLAIN_CHUNK):
        if bool((done | (length[:, None] <= base)).all()):
            break
        j = base + torch.arange(PLAIN_CHUNK, device=dev)
        in_range = j[None, :] < length[:, None]                 # (T, C)
        idx = torch.where(in_range, start[:, None] + j[None, :], 0)
        e = ent[:, idx]                                         # (9, T, C)
        dx = e[0][:, None, :] - px                              # (T, P, C)
        dy = e[1][:, None, :] - py
        c0, c1, c2 = (e[k][:, None, :] for k in (2, 3, 4))
        sigma = 0.5 * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy
        sigma = torch.clamp(sigma, min=0.0)
        alpha = torch.clamp(e[5][:, None, :] * torch.exp(-sigma),
                            max=max_alpha)
        ok = (alpha >= alpha_threshold) & in_range[:, None, :]
        for c in range(min(PLAIN_CHUNK, max_len - base)):
            a = alpha[..., c]
            live = ~done & in_range[:, c:c + 1]
            next_T = T * (1.0 - a)
            cross = live & ok[..., c] & (next_T <= transmittance_eps)
            comp = live & ok[..., c] & ~cross
            vis = a * T
            col = e[6:9, :, c].T[:, None, :]                    # (T, 1, 3)
            rgb = torch.where(comp[..., None], rgb + vis[..., None] * col, rgb)
            T = torch.where(comp, next_T, T)
            walked += (live & ~cross).to(torch.int32)
            done |= cross
    out = torch.cat([rgb, T[..., None]], dim=-1)
    return out, walked
