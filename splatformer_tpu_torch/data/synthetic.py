"""Synthetic scenes and cameras (port of splatformer_tpu/data/synthetic.py):
numpy draws from a ``np.random.Generator``, so the JAX package and the port
get the same values from the same seed."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.ops.types import Camera, GaussianScene


def random_scene(rng: np.random.Generator, n: int, sh_degree: int = 1,
                 n_valid: Optional[int] = None,
                 device: str = "cuda") -> GaussianScene:
    """n Gaussians with the statistics of normalised scenes (means in
    [0.05, 0.95]^3); slots from n_valid on are padding."""
    device = resolve_device(device)
    n_valid = n if n_valid is None else n_valid
    sh_rest = (sh_degree + 1) ** 2 - 1
    mask = np.zeros(n, dtype=bool)
    mask[:n_valid] = True

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    return GaussianScene(
        means=t(rng.uniform(0.05, 0.95, (n, 3))),
        scales=t(rng.uniform(-6.5, -4.5, (n, 3))),
        quats=t(rng.normal(size=(n, 4))),
        opacities=t(rng.normal(1.0, 1.0, (n, 1))),
        features_dc=t(rng.normal(0.0, 0.5, (n, 3))),
        features_rest=t(rng.normal(0.0, 0.1, (n, sh_rest, 3))),
        mask=torch.as_tensor(mask).to(device),
    )


def look_at_c2w(campos: np.ndarray, target: np.ndarray,
                up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL-convention camera-to-world looking from campos at target."""
    forward = target - campos
    forward = forward / np.linalg.norm(forward)
    z = -forward
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0] = x
    c2w[:3, 1] = y
    c2w[:3, 2] = z
    c2w[:3, 3] = campos
    return c2w


def orbit_cameras(n_views: int, height: int, width: int,
                  radius: float = 1.6, elevation_deg: float = 30.0,
                  target=(0.5, 0.5, 0.5), focal: Optional[float] = None,
                  device: str = "cuda") -> Camera:
    """A ring of cameras orbiting the unit-cube centre (batched Camera)."""
    device = resolve_device(device)
    target = np.asarray(target, dtype=np.float64)
    focal = focal if focal is not None else 1.2 * max(height, width)
    elev = np.deg2rad(elevation_deg)
    c2ws = []
    for i in range(n_views):
        az = 2 * np.pi * i / max(n_views, 1)
        campos = target + radius * np.array([
            np.cos(az) * np.cos(elev), np.sin(az) * np.cos(elev),
            np.sin(elev)])
        c2ws.append(look_at_c2w(campos, target))
    c2w = torch.as_tensor(np.stack(c2ws)[:, :3, :4], dtype=torch.float32)
    ones = torch.ones(n_views, dtype=torch.float32)
    return Camera(
        c2w=c2w.to(device), fx=(ones * focal).to(device),
        fy=(ones * focal).to(device), cx=(ones * (width / 2.0)).to(device),
        cy=(ones * (height / 2.0)).to(device), width=width, height=height)


def single_camera(cameras: Camera, i: int) -> Camera:
    """View ``i`` of a batched Camera, with scalar intrinsics."""
    return Camera(
        c2w=cameras.c2w[i], fx=cameras.fx[i], fy=cameras.fy[i],
        cx=cameras.cx[i], cy=cameras.cy[i],
        width=cameras.width, height=cameras.height)
