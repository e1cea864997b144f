"""K1, tile alpha-compositing forward, and K2, its backward: the CUDA
kernels' wrappers and their plain PyTorch versions.

Replace the Pallas TPU kernels ``fwd_kernel`` and ``bwd_kernel`` of
splatformer_tpu/ops/pallas/raster.py; the kernel sources are
csrc/composite_fwd.cu and csrc/composite_bwd.cu, whose headers state the
contract, what bounds each kernel on Hopper and what its design does about
it.

Inputs: ``packed_t`` (16, budget) f32 depth-sorted entries, rows
[x, y, conic0-2, opacity, r, g, b, pad...]; ``tile_start`` (num_tiles + 1,)
int32 unpadded per-tile ranges over V flattened views. Outputs: ``out``
(num_tiles, 256, 4) f32 = [sum rgb, T] per pixel, and ``walked``
(num_tiles, 256) int32, the number of leading entries of its tile's range
each pixel consumed before it terminated (the range length if it never did).
K2 takes those two and the cotangent of ``out`` and returns the gradient
with respect to ``packed_t``.
"""
from __future__ import annotations

import ctypes
import re
from typing import Dict, Tuple

import torch

from splatformer_tpu_torch.kernels import LAUNCHES
from splatformer_tpu_torch.kernels.build import CSRC_DIR, load

TILE = 16
PIXELS = TILE * TILE
USED_ROWS = 9
PLAIN_CHUNK = 64  # entries per step of the plain version's walk
# K1 and K2 give each warp an 8x4 box of its tile's pixels: warp w covers
# columns 8 (w % 2) .. +7 and rows 4 (w / 2) .. +3
BOX_W, BOX_H = 8, 4
BOXES = PIXELS // (BOX_W * BOX_H)


def _cull_constants() -> Dict[str, float]:
    """The kernels' cull constants (kCull*), read from the header that
    defines them for both kernels, so the plain version cannot drift."""
    text = (CSRC_DIR / "composite_common.cuh").read_text()
    return {k: float(v) for k, v in re.findall(
        r"constexpr float (kCull\w+) = ([-+.0-9e]+)f;", text)}


# the kernels' cull: a box is culled when op exp(-sigma_lb) stays under
# alpha_threshold (1 - CULL_SHARE), sigma_lb being the box minimum of sigma
# less CULL_REL of the terms' size and CULL_ABS; kept when the terms' size
# passes CULL_MAX_SIZE
CULL_SHARE, CULL_REL, CULL_ABS, CULL_MAX_SIZE = (
    _cull_constants()[k]
    for k in ("kCullShare", "kCullRel", "kCullAbs", "kCullMaxSize"))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> its argument types (csrc/composite_fwd.cu, _bwd.cu)
_ARGTYPES = {
    "composite_fwd": [_P, ctypes.c_longlong, _P, _I, _I, _I, _F, _F, _F, _P,
                      _P, _P],
    "composite_bwd": [_P, ctypes.c_longlong, _P, _I, _I, _I, _F, _F, _P, _P,
                      _P, _P, _P]}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the entry points ``lib`` exports (K1's
    ``composite_fwd``, K2's ``composite_bwd``); returns ``lib``."""
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _library(name: str) -> ctypes.CDLL:
    return bind(load(name))


def launch_fwd(lib: ctypes.CDLL, packed_t: torch.Tensor,
               tile_start: torch.Tensor, tiles_x: int, tiles_img: int,
               alpha_threshold: float, max_alpha: float,
               transmittance_eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lib``'s K1 on contiguous, checked CUDA tensors; returns
    (out, walked)."""
    num_tiles = tile_start.shape[0] - 1
    out = torch.empty((num_tiles, PIXELS, 4), dtype=torch.float32,
                      device=packed_t.device)
    walked = torch.empty((num_tiles, PIXELS), dtype=torch.int32,
                         device=packed_t.device)
    stream = torch.cuda.current_stream(packed_t.device).cuda_stream
    err = lib.composite_fwd(
        packed_t.data_ptr(), packed_t.shape[1], tile_start.data_ptr(),
        num_tiles, tiles_x, tiles_img, alpha_threshold, max_alpha,
        transmittance_eps, out.data_ptr(), walked.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {err}")
    return out, walked


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
    _check(packed_t, tile_start, tiles_x, tiles_img)
    if packed_t.device.type == "cpu":
        return composite_fwd_plain(packed_t, tile_start, tiles_x, tiles_img,
                                   alpha_threshold, max_alpha,
                                   transmittance_eps)
    if packed_t.device.type != "cuda":
        raise ValueError(f"no composite_fwd for device {packed_t.device}")
    out, walked = launch_fwd(_library("composite_fwd"),
                             packed_t.contiguous(), tile_start.contiguous(),
                             tiles_x, tiles_img, alpha_threshold, max_alpha,
                             transmittance_eps)
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


def pixel_box() -> torch.Tensor:
    """(256,) int64: the warp box (0-7) of each pixel p of a tile."""
    p = torch.arange(PIXELS)
    return (p // TILE // BOX_H) * (TILE // BOX_W) + (p % TILE) // BOX_W


def warp_box_max(x: torch.Tensor) -> torch.Tensor:
    """(T, 8): the largest of x (T, 256) over each warp's 8x4 pixel box."""
    box = pixel_box().to(x.device)
    return torch.stack([x[:, box == w].max(dim=1).values
                        for w in range(BOXES)], dim=1)


def warp_box_keep_plain(packed_t: torch.Tensor, tile_start: torch.Tensor,
                        tiles_x: int, tiles_img: int,
                        alpha_threshold: float = 1.0 / 255.0,
                        chunk: int = 256) -> torch.Tensor:
    """K1's and K2's keep bit of every (tile, warp box, entry), in plain
    PyTorch on any device, float32 as the kernels compute it. Returns
    (num_tiles, 8, longest range) bool: [t, w, j] for entry tile_start[t] + j
    and box w (``pixel_box``), False past the tile's range.

    A box is dropped only when the entry's alpha provably stays under the
    threshold at every pixel of the box: op exp(-sigma_lb) <
    alpha_threshold (1 - CULL_SHARE), where sigma_lb is the continuous
    minimum of sigma over the box of pixel centres (0 if the centre lies
    inside it, else the least of the four edges' minima at their clamped
    critical points) less CULL_REL of the terms' size (|c0|/2 dx^2 + |c1|
    |dx dy| + |c2|/2 dy^2 at the box's largest |dx|, |dy|) and CULL_ABS. Kept
    unless c0 > 0, c2 > 0, c0 c2 > c1^2 and every value is finite."""
    num_tiles = _check(packed_t, tile_start, tiles_x, tiles_img)
    dev = packed_t.device
    start = tile_start[:-1].to(torch.int64)
    length = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    local = torch.arange(num_tiles, device=dev) % tiles_img
    w = torch.arange(BOXES, device=dev)
    bx = ((local % tiles_x) * TILE)[:, None] + BOX_W * (w % 2)[None, :]
    by = (torch.div(local, tiles_x, rounding_mode="floor") * TILE)[:, None] \
        + BOX_H * torch.div(w, 2, rounding_mode="floor")[None, :]
    bx = bx.to(torch.float32)[:, :, None]                       # (T, 8, 1)
    by = by.to(torch.float32)[:, :, None]
    f32 = dict(dtype=torch.float32, device=dev)
    thr = (torch.tensor(alpha_threshold, **f32)
           * (torch.tensor(1.0, **f32) - torch.tensor(CULL_SHARE, **f32)))
    cull_ok = bool(thr > 0)

    def quad(c0, c1, c2, dx, dy):
        return 0.5 * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy

    def clamp(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    max_len = int(length.max()) if num_tiles else 0
    keep = torch.zeros((num_tiles, BOXES, max_len), dtype=torch.bool,
                       device=dev)
    for base in range(0, max_len, chunk):
        j = base + torch.arange(min(chunk, max_len - base), device=dev)
        in_range = j[None, :] < length[:, None]                 # (T, C)
        idx = torch.where(in_range, start[:, None] + j[None, :], 0)
        mx, my, c0, c1, c2, op = (packed_t[k, idx][:, None, :]
                                  for k in range(6))            # (T, 1, C)
        kx, ky = c1 / c2, c1 / c0
        testable = (torch.isfinite(torch.stack([mx, my, c0, c1, c2, op, kx,
                                                ky])).all(dim=0)
                    & (c0 > 0) & (c2 > 0) & (c0 * c2 > c1 * c1))
        xlo, xhi = mx - (bx + 7.0), mx - bx                     # (T, 8, C)
        ylo, yhi = my - (by + 3.0), my - by
        outside = (xlo > 0) | (xhi < 0) | (ylo > 0) | (yhi < 0)
        edges = torch.stack([
            quad(c0, c1, c2, xlo, clamp(-(kx * xlo), ylo, yhi)),
            quad(c0, c1, c2, xhi, clamp(-(kx * xhi), ylo, yhi)),
            quad(c0, c1, c2, clamp(-(ky * ylo), xlo, xhi), ylo),
            quad(c0, c1, c2, clamp(-(ky * yhi), xlo, xhi), yhi)])
        s = torch.where(outside & testable, edges.min(dim=0).values, 0.0)
        ax = torch.maximum(xlo.abs(), xhi.abs())
        ay = torch.maximum(ylo.abs(), yhi.abs())
        size = 0.5 * c0 * ax * ax + c1.abs() * ax * ay + 0.5 * c2 * ay * ay
        lb = torch.clamp(s - (CULL_REL * size + CULL_ABS), min=0.0)
        culled = (testable & (size <= CULL_MAX_SIZE)
                  & (op * torch.exp(-lb) < thr) & cull_ok)
        keep[:, :, j] = ~culled & in_range[:, None, :]
    return keep


def launch_bwd(lib: ctypes.CDLL, packed_t: torch.Tensor,
               tile_start: torch.Tensor, tiles_x: int, tiles_img: int,
               out: torch.Tensor, walked: torch.Tensor, g_out: torch.Tensor,
               alpha_threshold: float, max_alpha: float) -> torch.Tensor:
    """Launch ``lib``'s K2 on contiguous, checked CUDA tensors; returns
    d_packed."""
    d_packed = torch.zeros_like(packed_t)
    stream = torch.cuda.current_stream(packed_t.device).cuda_stream
    err = lib.composite_bwd(
        packed_t.data_ptr(), packed_t.shape[1], tile_start.data_ptr(),
        tile_start.shape[0] - 1, tiles_x, tiles_img, alpha_threshold,
        max_alpha, out.data_ptr(), walked.data_ptr(), g_out.data_ptr(),
        d_packed.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: cudaError {err}")
    return d_packed


def _check_saved(num_tiles: int, out: torch.Tensor, walked: torch.Tensor,
                 g_out: torch.Tensor, device: torch.device) -> None:
    for name, x, dtype, shape in (
            ("out", out, torch.float32, (num_tiles, PIXELS, 4)),
            ("walked", walked, torch.int32, (num_tiles, PIXELS)),
            ("g_out", g_out, torch.float32, (num_tiles, PIXELS, 4))):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
            raise ValueError(f"{name} must be {shape} {dtype} on {device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def composite_bwd(packed_t: torch.Tensor, tile_start: torch.Tensor,
                  tiles_x: int, tiles_img: int, out: torch.Tensor,
                  walked: torch.Tensor, g_out: torch.Tensor,
                  alpha_threshold: float = 1.0 / 255.0,
                  max_alpha: float = 0.999) -> torch.Tensor:
    """K2: the gradient of K1's ``out`` with respect to ``packed_t``, given
    K1's saved ``out`` and ``walked`` and the cotangent ``g_out``.

    Returns ``d_packed`` (16, budget) f32, rows [dx, dy, dconic0-2,
    dopacity, dr, dg, db] and exact zeros elsewhere: in rows 9-15 and in
    every entry column that no pixel replayed. CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version."""
    num_tiles = _check(packed_t, tile_start, tiles_x, tiles_img)
    _check_saved(num_tiles, out, walked, g_out, packed_t.device)
    if packed_t.device.type == "cpu":
        return composite_bwd_plain(packed_t, tile_start, tiles_x, tiles_img,
                                   out, walked, g_out, alpha_threshold,
                                   max_alpha)
    if packed_t.device.type != "cuda":
        raise ValueError(f"no composite_bwd for device {packed_t.device}")
    d_packed = launch_bwd(_library("composite_bwd"), packed_t.contiguous(),
                          tile_start.contiguous(), tiles_x, tiles_img,
                          out.contiguous(), walked.contiguous(),
                          g_out.contiguous(), alpha_threshold, max_alpha)
    LAUNCHES["composite_bwd"] += 1
    return d_packed


def composite_bwd_plain(packed_t: torch.Tensor, tile_start: torch.Tensor,
                        tiles_x: int, tiles_img: int, out: torch.Tensor,
                        walked: torch.Tensor, g_out: torch.Tensor,
                        alpha_threshold: float = 1.0 / 255.0,
                        max_alpha: float = 0.999) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: vectorised over
    tiles and pixels, PLAIN_CHUNK entries at a time. Each pixel replays its
    first ``walked`` entries with K1's operations, stepping the
    transmittance and the remaining colour sum S entry by entry:

        da = T_excl (g_rgb . c) - (S_total - sum_{i<=j} g_rgb . c_i vis_i
                                   + g_T T_final) / (1 - a)

    with S_total = g_rgb . rgb_acc from the saved output (gsplat's
    back-to-front suffix sums recovered front to back). The max-alpha clamp
    gates d-alpha (raw < max_alpha); the sigma clamp takes the full
    derivative. Each entry's 9 values are summed over its tile's pixels."""
    num_tiles = _check(packed_t, tile_start, tiles_x, tiles_img)
    _check_saved(num_tiles, out, walked, g_out, packed_t.device)
    dev = packed_t.device
    d_packed = torch.zeros_like(packed_t)
    start = tile_start[:-1].to(torch.int64)
    length = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    local = torch.arange(num_tiles, device=dev) % tiles_img
    p = torch.arange(PIXELS, device=dev)
    px = ((local % tiles_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = (torch.div(local, tiles_x, rounding_mode="floor") * TILE)[:, None] \
        + torch.div(p, TILE, rounding_mode="floor")[None, :]
    px = px.to(torch.float32)[:, :, None]
    py = py.to(torch.float32)[:, :, None]

    g0, g1, g2, g_t = g_out.unbind(-1)                         # (T, P)
    o0, o1, o2, o_t = out.unbind(-1)
    s_rem = g0 * o0 + g1 * o1 + g2 * o2
    gt_term = g_t * o_t
    T = torch.ones((num_tiles, PIXELS), dtype=torch.float32, device=dev)
    n_walk = walked.to(torch.int64)
    ent = packed_t[:USED_ROWS]
    max_walk = int(n_walk.max()) if num_tiles else 0
    for base in range(0, max_walk, PLAIN_CHUNK):
        c_n = min(PLAIN_CHUNK, max_walk - base)
        j = base + torch.arange(c_n, device=dev)
        in_range = j[None, :] < length[:, None]                 # (T, C)
        idx = torch.where(in_range, start[:, None] + j[None, :], 0)
        e = ent[:, idx]                                         # (9, T, C)
        dx = e[0][:, None, :] - px                              # (T, P, C)
        dy = e[1][:, None, :] - py
        c0, c1, c2 = (e[k][:, None, :] for k in (2, 3, 4))
        sigma = 0.5 * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy
        sigma = torch.clamp(sigma, min=0.0)
        ex = torch.exp(-sigma)
        raw = e[5][:, None, :] * ex
        alpha = torch.clamp(raw, max=max_alpha)
        live = ((alpha >= alpha_threshold)
                & (j[None, None, :] < n_walk[:, :, None]))
        gc = (g0[..., None] * e[6][:, None, :]
              + g1[..., None] * e[7][:, None, :]
              + g2[..., None] * e[8][:, None, :])
        da = torch.zeros_like(alpha)
        vis = torch.zeros_like(alpha)
        for c in range(c_n):
            a, on = alpha[..., c], live[..., c]
            v = a * T
            s_rem = torch.where(on, s_rem - gc[..., c] * v, s_rem)
            da[..., c] = torch.where(
                on, T * gc[..., c] - (s_rem + gt_term) / (1.0 - a), 0.0)
            vis[..., c] = torch.where(on, v, 0.0)
            T = torch.where(on, T * (1.0 - a), T)
        dsig = torch.where(live & (raw < max_alpha), -raw * da, 0.0)
        rows = [dsig * (c0 * dx + c1 * dy),
                dsig * (c1 * dx + c2 * dy),
                0.5 * dsig * dx * dx,
                dsig * dx * dy,
                0.5 * dsig * dy * dy,
                torch.where(live & (raw < max_alpha), da * ex, 0.0),
                g0[..., None] * vis, g1[..., None] * vis, g2[..., None] * vis]
        sums = torch.stack([r.sum(dim=1) for r in rows])         # (9, T, C)
        d_packed[:USED_ROWS, idx[in_range]] = sums[:, in_range]
    return d_packed
