"""Camera math (a frozen copy of splatformer_tpu_torch/ops/camera.py): OpenGL c2w -> OpenCV
w2c view matrices, wxyz quaternion utilities and their inverse,
rotmat_to_quat."""
from __future__ import annotations

import torch


def opengl_c2w_to_opencv_w2c(c2w: torch.Tensor) -> torch.Tensor:
    """(3, 4) or (4, 4) OpenGL camera-to-world -> (4, 4) OpenCV
    world-to-camera: flip the camera's y and z axes, then invert
    analytically (R^T, -R^T t)."""
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=R.dtype, device=R.device)
    R_inv = (R * flip[None, :]).T
    t_inv = -torch.sum(R_inv * t[None, :], dim=-1)
    view = torch.eye(4, dtype=R.dtype, device=R.device)
    view[:3, :3] = R_inv
    view[:3, 3] = t_inv
    return view


def normalize_quats(quats: torch.Tensor) -> torch.Tensor:
    """Normalize wxyz quaternions; near-zero-norm ones become the
    reference's fallback [0, 0, 0, 1]."""
    sq = torch.sum(quats * quats, dim=-1, keepdim=True)
    ok = sq > 1e-12
    denom = torch.sqrt(torch.where(ok, sq, torch.ones_like(sq)))
    fallback = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=quats.dtype,
                            device=quats.device)
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
