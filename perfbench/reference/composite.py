"""The compositing forward and backward in plain PyTorch (a frozen copy of
the plain versions in splatformer_tpu_torch/kernels/composite.py, which the
program's K1 and K2 kernels are held to): vectorised over tiles and pixels,
walking each tile's depth-sorted entries PLAIN_CHUNK at a time."""
from __future__ import annotations

from typing import Tuple

import torch

TILE = 16
PIXELS = TILE * TILE
USED_ROWS = 9
PLAIN_CHUNK = 64  # entries per step of the walk


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


def _check_saved(num_tiles: int, out: torch.Tensor, walked: torch.Tensor,
                 g_out: torch.Tensor, device: torch.device) -> None:
    for name, x, dtype, shape in (
            ("out", out, torch.float32, (num_tiles, PIXELS, 4)),
            ("walked", walked, torch.int32, (num_tiles, PIXELS)),
            ("g_out", g_out, torch.float32, (num_tiles, PIXELS, 4))):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
            raise ValueError(f"{name} must be {shape} {dtype} on {device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


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
