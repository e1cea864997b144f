"""Packed-entry compositing (a frozen copy of
splatformer_tpu_torch/ops/raster.py with the plain forward and backward of
composite.py in place of the K1 and K2 kernels): the transposed entry pack,
the entry gather, the differentiable compositing function and
``composite_packed``'s untile and background blend."""
from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.composite import (composite_bwd_plain as composite_bwd,
                                          composite_fwd_plain as composite_fwd)

PACK_W = 16   # packed attribute rows (9 used)
CHUNK = 128   # per-view Gaussian axis padded to a multiple of this


def pack_entries_t(xy, conic, color, opac) -> torch.Tensor:
    """-> (PACK_W, n_pad) transposed packed rows [x, y, conic0-2, opacity,
    r, g, b, 0...], the Gaussian axis zero-padded to a multiple of CHUNK."""
    n = xy.shape[0]
    n_pad = ((n + CHUNK - 1) // CHUNK) * CHUNK
    out = torch.zeros((PACK_W, n_pad), dtype=torch.float32, device=xy.device)
    out[0:2, :n] = xy.T
    out[2:5, :n] = conic.T
    out[5, :n] = opac
    out[6:9, :n] = color.T
    return out


def gather_entries(pgauss_t: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian packed rows (PACK_W, N) -> per-entry (PACK_W, budget).

    Its autograd backward (``index_add_`` over the Gaussian axis) is the
    function that the JAX package's sort-based segment-sum ``custom_vjp``
    computes (a TPU scatter workaround). Padding and over-budget slots
    resolve to Gaussian 0; they add nothing to its gradient because K2
    leaves exact zeros in every entry column that no pixel replays."""
    return pgauss_t.index_select(1, gidx)


class CompositePacked(torch.autograd.Function):
    """Compositing of packed entries: K1 forward, K2 backward. Returns K1's
    ``out`` (num_tiles, 256, 4) = [sum rgb, T]; the gradient flows to
    ``packed_t`` only."""

    @staticmethod
    def forward(ctx, packed_t, tile_start, tiles_x, tiles_img,
                alpha_threshold, max_alpha, transmittance_eps):
        out, walked = composite_fwd(packed_t, tile_start, tiles_x, tiles_img,
                                    alpha_threshold, max_alpha,
                                    transmittance_eps)
        ctx.save_for_backward(packed_t, tile_start, out, walked)
        ctx.params = (tiles_x, tiles_img, alpha_threshold, max_alpha)
        return out

    @staticmethod
    def backward(ctx, g_out):
        packed_t, tile_start, out, walked = ctx.saved_tensors
        tiles_x, tiles_img, athr, amax = ctx.params
        d_packed = composite_bwd(packed_t, tile_start, tiles_x, tiles_img,
                                 out, walked, g_out.contiguous(), athr, amax)
        return d_packed, None, None, None, None, None, None


def composite_packed(
    packed_t: torch.Tensor, tile_start: torch.Tensor,
    img_height: int, img_width: int, tile_size: int,
    background: torch.Tensor,
    alpha_threshold: float = 1.0 / 255.0, max_alpha: float = 0.999,
    transmittance_eps: float = 1e-4, num_images: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite depth-sorted packed entries over V flattened views.

    Tile t owns the unpadded range [tile_start[t], tile_start[t+1]).
    Returns (V, H, W, 3) rgb = sum + T * background and (V, H, W) alpha =
    1 - T."""
    if tile_size != 16:
        raise ValueError("the compositing kernel works on 16x16 tiles")
    ts = tile_size
    tiles_x = (img_width + ts - 1) // ts
    tiles_y = (img_height + ts - 1) // ts
    out = CompositePacked.apply(packed_t, tile_start.to(torch.int32),
                                tiles_x, tiles_x * tiles_y, alpha_threshold,
                                max_alpha, transmittance_eps)
    v = num_images
    img = (out.reshape(v, tiles_y, tiles_x, ts, ts, 4)
           .permute(0, 1, 3, 2, 4, 5)
           .reshape(v, tiles_y * ts, tiles_x * ts, 4))
    img = img[:, :img_height, :img_width]
    t_img = img[..., 3]
    rgb = img[..., 0:3] + t_img[..., None] * background[None, None, None, :]
    return rgb, 1.0 - t_img
