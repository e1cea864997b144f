"""3D Gaussian -> 2D screen-space projection, gsplat v0.1.11 semantics (port of
splatformer_tpu/ops/projection.py), and the activations and SH colours
that precede it (port of the JAX package's render.py helpers).

quat -> R, cov3d = (R S)(R S)^T; view transform with a near-plane cull at
z <= clip_thresh; EWA with the 1.3 tan_fov frustum clamp; +0.3 pixel blur;
conic = inverse blurred covariance; extents
from the exact opacity-aware alpha-gate crossing; per-axis tile spans.

Every function broadcasts over a leading view axis: a (V, 4, 4) view
matrix with (V,) intrinsics, or (V, 3) camera positions, gives outputs of
shape (V, N, ...); a (4, 4) one gives (N, ...). Small 3x3 products are
written as explicit elementwise ops over per-component tensors, so that
the fused projection kernel (csrc/projection_common.cuh) can repeat every
rounding step. A sum that was a torch.sum or a norm over three elements
is taken in the order of PyTorch's CUDA reduction, (a0 + a2) + a1, so that
on the card it gives those calls' bits.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from splatformer_tpu_torch.ops import sh as sh_ops
from splatformer_tpu_torch.ops.camera import normalize_quats, quat_to_rotmat
from splatformer_tpu_torch.ops.types import GaussianScene


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities (all shape (N, ...))."""

    xys: torch.Tensor            # (N, 2) pixel centres
    depths: torch.Tensor         # (N,) camera-space z, inf where culled
    radii: torch.Tensor          # (N,) int32 pixel radius (0 = culled)
    conics: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    num_tiles_hit: torch.Tensor  # (N,) int32
    radii_xy: torch.Tensor       # (N, 2) per-axis extents of the alpha gate


def activate_gaussians(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    """Raw -> rendering-space activations: exp(scales), renormalised quats
    with the degenerate fallback, sigmoid(opacities)."""
    return {
        "means": scene.means,
        "scales": torch.exp(scene.scales),
        "quats": normalize_quats(scene.quats),
        "opacities": torch.sigmoid(scene.opacities[..., 0]),
    }


def compute_colors(scene: GaussianScene, campos: torch.Tensor) -> torch.Tensor:
    """Colours seen from ``campos`` (3,) -> (N, 3), or (V, 3) -> (V, N, 3):
    sigmoid(features_dc) at SH degree 0 (the same for every view: (N, 3)),
    else SH along the camera->mean direction, clamp(rgb + 0.5, min=0). A
    Gaussian exactly at the camera takes the deterministic direction
    [0, 0, 1]. No gradient reaches the means or the camera."""
    degree = scene.sh_degree
    if degree == 0:
        return torch.sigmoid(scene.features_dc)
    coeffs = torch.cat([scene.features_dc[:, None, :], scene.features_rest],
                       dim=1)
    campos = campos.detach()
    if campos.ndim == 2:
        campos = campos[:, None, :]
    d = scene.means.detach() - campos
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    norm = torch.sqrt((dx * dx + dz * dz) + dy * dy)
    ok = norm > 0
    inv = torch.clamp(norm, min=1e-12)
    viewdirs = torch.cat([torch.where(ok, dx / inv, 0.0),
                          torch.where(ok, dy / inv, 0.0),
                          torch.where(ok, dz / inv, 1.0)], dim=-1)
    rgb = sh_ops.eval_sh(degree, viewdirs, coeffs) + 0.5
    # maximum, not clamp: at a tie it splits the gradient as jnp.clip does
    return torch.maximum(rgb, torch.zeros_like(rgb))


def scale_quat_to_cov3d(scales: torch.Tensor, quats: torch.Tensor
                        ) -> torch.Tensor:
    """(N, 3) linear scales + (N, 4) wxyz quats -> (N, 6) packed covariance
    [c00, c01, c02, c11, c12, c22]."""
    R = quat_to_rotmat(normalize_quats(quats))
    M = R * scales[..., None, :]

    def rowdot(i, j):
        return (M[..., i, 0] * M[..., j, 0] + M[..., i, 1] * M[..., j, 1]
                + M[..., i, 2] * M[..., j, 2])
    return torch.stack(
        [rowdot(0, 0), rowdot(0, 1), rowdot(0, 2),
         rowdot(1, 1), rowdot(1, 2), rowdot(2, 2)], dim=-1)


def _per_view(x):
    """A per-view scalar as a column against the Gaussian axis: (V,) ->
    (V, 1); a 0-d tensor or a number as it is."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x[..., None]
    return x


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx, fy, cx, cy,
    img_height: int,
    img_width: int,
    tile_size: int = 16,
    clip_thresh: float = 0.01,
    mask: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    alpha_threshold: float = 1.0 / 255.0,
) -> ProjectedGaussians:
    """Project N Gaussians through the (4, 4) OpenCV world-to-camera
    ``viewmat``, or through (V, 4, 4) ones with (V,) intrinsics (outputs
    (V, N, ...)). Masked Gaussians get radius 0. With post-sigmoid
    ``opacities`` the extents are the exact alpha-gate crossing
    sqrt(2 ln(op / athr)) standard deviations (zero at op <= athr)."""
    R = [[viewmat[..., i, j, None] for j in range(3)] for i in range(3)]
    t = [viewmat[..., i, 3, None] for i in range(3)]
    fx, fy, cx, cy = (_per_view(c) for c in (fx, fy, cx, cy))
    m = means.unbind(-1)

    c00, c01, c02, c11, c12, c22 = scale_quat_to_cov3d(scales,
                                                       quats).unbind(-1)

    p0, p1, tz = ((m[0] * R[i][0] + m[2] * R[i][2]) + m[1] * R[i][1] + t[i]
                  for i in range(3))
    valid = tz > clip_thresh
    if mask is not None:
        valid = valid & mask
    one = torch.ones_like(tz)
    tz_safe = torch.where(valid, tz, one)

    tan_fovx = 0.5 * img_width / fx
    tan_fovy = 0.5 * img_height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.minimum(torch.maximum(p0, -lim_x * tz_safe), lim_x * tz_safe)
    ty = torch.minimum(torch.maximum(p1, -lim_y * tz_safe), lim_y * tz_safe)

    rz = 1.0 / tz_safe
    rz2 = rz * rz
    J00 = fx * rz
    J02 = -fx * tx * rz2
    J11 = fy * rz
    J12 = -fy * ty * rz2
    T0 = [J00 * R[0][j] + J02 * R[2][j] for j in range(3)]
    T1 = [J11 * R[1][j] + J12 * R[2][j] for j in range(3)]

    def quad(u, v):
        return (u[0] * (c00 * v[0] + c01 * v[1] + c02 * v[2])
                + u[1] * (c01 * v[0] + c11 * v[1] + c12 * v[2])
                + u[2] * (c02 * v[0] + c12 * v[1] + c22 * v[2]))

    v00 = quad(T0, T0)
    v01 = quad(T0, T1)
    v11 = quad(T1, T1)

    b00 = v00 + 0.3
    b11 = v11 + 0.3
    det_blur = b00 * b11 - v01 * v01

    det_ok = det_blur != 0.0
    det_safe = torch.where(det_ok, det_blur, one)
    inv_det = 1.0 / det_safe
    conic = torch.stack([b11 * inv_det, -v01 * inv_det, b00 * inv_det], dim=-1)

    # the extent multiplier depends on the Gaussian alone, not the view
    if opacities is None:
        k_max = math.sqrt(2.0 * math.log(1.0 / alpha_threshold))
        k_ext = torch.full_like(m[0], k_max)
    else:
        ratio = opacities * (1.0 / alpha_threshold)
        k_ext = torch.where(
            ratio > 1.0,
            torch.sqrt(2.0 * torch.log(torch.clamp(ratio, min=1.0))), 0.0)

    bmid = 0.5 * (b00 + b11)
    disc = torch.sqrt(torch.clamp(bmid * bmid - det_safe, min=0.1))
    v1 = bmid + disc
    v2 = bmid - disc
    radius_f = torch.ceil(
        k_ext * torch.sqrt(torch.clamp(torch.maximum(v1, v2), min=0.0)))
    rx = torch.ceil(k_ext * torch.sqrt(torch.clamp(b00, min=0.0)))
    ry = torch.ceil(k_ext * torch.sqrt(torch.clamp(b11, min=0.0)))

    xs = fx * p0 * rz + cx
    ys = fy * p1 * rz + cy
    xys = torch.stack([xs, ys], dim=-1)

    valid = valid & det_ok
    zero = torch.zeros_like(tz)
    radii = torch.where(valid, radius_f, zero).to(torch.int32)
    rx = torch.where(valid, rx, zero)
    ry = torch.where(valid, ry, zero)
    radii_xy = torch.stack([rx, ry], dim=-1)

    tiles_x = (img_width + tile_size - 1) // tile_size
    tiles_y = (img_height + tile_size - 1) // tile_size
    tmin_x, tmin_y, tmax_x, tmax_y = tile_bbox(xys, radii_xy, tile_size,
                                               tiles_x, tiles_y)
    span = (tmax_x - tmin_x) * (tmax_y - tmin_y)
    num_tiles_hit = torch.where(radii > 0, span,
                                torch.zeros_like(span)).to(torch.int32)

    depths = torch.where(valid, tz, torch.full_like(tz, math.inf))
    return ProjectedGaussians(
        xys=xys, depths=depths, radii=radii, conics=conic,
        num_tiles_hit=num_tiles_hit, radii_xy=radii_xy)


def tile_bbox(xys: torch.Tensor, radii_xy: torch.Tensor, tile_size: int,
              tiles_x: int, tiles_y: int):
    """Per-Gaussian tile bbox (tmin_x, tmin_y, tmax_x, tmax_y), exclusive
    max, int32, from the (..., 2) centres and per-axis extents."""
    rx, ry = radii_xy[..., 0], radii_xy[..., 1]

    def cell(v, hi):
        # clamp in float first: XLA's float->int32 cast saturates, torch's
        # is undefined out of range
        return torch.clamp(torch.clamp(v, -1.0, hi + 1.0).to(torch.int32),
                           0, hi)

    tmin_x = cell((xys[..., 0] - rx) / tile_size, tiles_x)
    tmax_x = cell((xys[..., 0] + rx) / tile_size + 1.0, tiles_x)
    tmin_y = cell((xys[..., 1] - ry) / tile_size, tiles_y)
    tmax_y = cell((xys[..., 1] + ry) / tile_size + 1.0, tiles_y)
    return tmin_x, tmin_y, tmax_x, tmax_y
