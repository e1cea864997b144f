"""Camera math (port of splatformer_tpu/ops/camera.py): OpenGL c2w -> OpenCV
w2c view matrices, wxyz quaternion utilities and their inverse,
rotmat_to_quat."""
from __future__ import annotations

import torch


def opengl_c2w_to_opencv_w2c(c2w: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) OpenGL camera-to-world -> (..., 4, 4)
    OpenCV world-to-camera: flip the camera's y and z axes, then invert
    analytically (R^T, -R^T t). Row i of R^T is column i of R, negated for
    the flipped axes. -R^T t is summed left to right: the order in which
    PyTorch's CUDA reduction sums the rows of the transposed (column-major)
    product that torch.sum(R^T * t, -1) reduces, so that every device gives
    what that call gives on the card (and the projection kernel,
    csrc/projection_common.cuh, repeats it)."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    R_inv = torch.stack([R[..., :, 0], -R[..., :, 1], -R[..., :, 2]], dim=-2)
    t_inv = -(R_inv[..., 0] * t[..., 0:1] + R_inv[..., 1] * t[..., 1:2]
              + R_inv[..., 2] * t[..., 2:3])
    bottom = torch.zeros_like(c2w[..., :1, :4])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R_inv, t_inv[..., None]], dim=-1), bottom],
                     dim=-2)


def normalize_quats(quats: torch.Tensor) -> torch.Tensor:
    """Normalize wxyz quaternions; near-zero-norm ones become the
    reference's fallback [0, 0, 0, 1]. The squared norm is summed in the
    order of PyTorch's CUDA reduction of four elements, (w^2 + y^2) +
    (x^2 + z^2)."""
    w, x, y, z = quats.unbind(-1)
    sq = ((w * w + y * y) + (x * x + z * z))[..., None]
    ok = sq > 1e-12
    denom = torch.sqrt(torch.where(ok, sq, torch.ones_like(sq)))
    fallback = torch.zeros_like(quats)
    fallback[..., 3] = 1.0
    return torch.where(ok, quats / denom, fallback)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """wxyz unit quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
    w, x, y, z = quats.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> wxyz quaternions (..., 4).

    Branch-free Shepperd-style construction (valid for proper rotations)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return 0.5 * torch.sqrt(torch.clamp(x, min=1e-12))
    qw = half_sqrt(1.0 + tr)
    qx = torch.copysign(half_sqrt(1.0 + m00 - m11 - m22), m21 - m12)
    qy = torch.copysign(half_sqrt(1.0 - m00 + m11 - m22), m02 - m20)
    qz = torch.copysign(half_sqrt(1.0 - m00 - m11 + m22), m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
