"""Real spherical-harmonics colour evaluation, gsplat v0.1.11 basis and
constants (a frozen copy of splatformer_tpu_torch/ops/sh.py)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb):
    """rgb -> SH degree-0 coefficient (the reference's RGB2SH); operators
    only, so numpy arrays stay numpy."""
    return (rgb - 0.5) / C0


def eval_sh(degree: int, viewdirs: torch.Tensor,
            coeffs: torch.Tensor) -> torch.Tensor:
    """viewdirs (..., 3) unit, coeffs (..., num_sh_bases(degree), 3) ->
    colours (..., 3), before the renderer's +0.5 shift and clamp."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree {degree} outside [0, 4]")
    if coeffs.shape[-2] < num_sh_bases(degree):
        raise ValueError(f"{coeffs.shape[-2]} SH bases for degree {degree}")
    result = C0 * coeffs[..., 0, :]
    if degree < 1:
        return result
    x = viewdirs[..., 0:1]
    y = viewdirs[..., 1:2]
    z = viewdirs[..., 2:3]
    result = result + C1 * (-y * coeffs[..., 1, :] + z * coeffs[..., 2, :]
                            - x * coeffs[..., 3, :])
    if degree < 2:
        return result
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = result + (
        C2[0] * xy * coeffs[..., 4, :]
        + C2[1] * yz * coeffs[..., 5, :]
        + C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
        + C2[3] * xz * coeffs[..., 7, :]
        + C2[4] * (xx - yy) * coeffs[..., 8, :]
    )
    if degree < 3:
        return result
    result = result + (
        C3[0] * y * (3.0 * xx - yy) * coeffs[..., 9, :]
        + C3[1] * xy * z * coeffs[..., 10, :]
        + C3[2] * y * (4.0 * zz - xx - yy) * coeffs[..., 11, :]
        + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeffs[..., 12, :]
        + C3[4] * x * (4.0 * zz - xx - yy) * coeffs[..., 13, :]
        + C3[5] * z * (xx - yy) * coeffs[..., 14, :]
        + C3[6] * x * (xx - 3.0 * yy) * coeffs[..., 15, :]
    )
    if degree < 4:
        return result
    result = result + (
        C4[0] * xy * (xx - yy) * coeffs[..., 16, :]
        + C4[1] * yz * (3.0 * xx - yy) * coeffs[..., 17, :]
        + C4[2] * xy * (7.0 * zz - 1.0) * coeffs[..., 18, :]
        + C4[3] * yz * (7.0 * zz - 3.0) * coeffs[..., 19, :]
        + C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * coeffs[..., 20, :]
        + C4[5] * xz * (7.0 * zz - 3.0) * coeffs[..., 21, :]
        + C4[6] * (xx - yy) * (7.0 * zz - 1.0) * coeffs[..., 22, :]
        + C4[7] * xz * (xx - 3.0 * yy) * coeffs[..., 23, :]
        + C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))
        * coeffs[..., 24, :]
    )
    return result
