"""Scenes and cameras made from the seed: a frozen copy of the numpy draws
of splatformer_tpu_torch/data/synthetic.py (``random_scene``,
``look_at_c2w``, ``orbit_cameras``), returned as plain dicts of tensors so
that the program and the reference each wrap them in their own types."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

SCENE_KEYS = ("means", "scales", "quats", "opacities", "features_dc",
              "features_rest", "mask")


def pool_sizes(n_min: int, n_max: int, pool: int) -> List[int]:
    """``pool`` live counts spread evenly over [n_min, n_max]: every seed
    gets the same sizes, in its own order."""
    step = (n_max - n_min) / pool
    return [int(round(n_min + (i + 0.5) * step)) for i in range(pool)]


def random_scene(rng: np.random.Generator, n: int, sh_degree: int,
                 n_valid: int) -> Dict[str, np.ndarray]:
    """n Gaussians with the statistics of normalised scenes (means in
    [0.05, 0.95]^3); slots from n_valid on are padding."""
    sh_rest = (sh_degree + 1) ** 2 - 1
    mask = np.zeros(n, dtype=bool)
    mask[:n_valid] = True
    return {
        "means": rng.uniform(0.05, 0.95, (n, 3)),
        "scales": rng.uniform(-6.5, -4.5, (n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "opacities": rng.normal(1.0, 1.0, (n, 1)),
        "features_dc": rng.normal(0.0, 0.5, (n, 3)),
        "features_rest": rng.normal(0.0, 0.1, (n, sh_rest, 3)),
        "mask": mask,
    }


def to_device(scene: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in scene.items():
        dtype = torch.bool if k == "mask" else torch.float32
        out[k] = torch.as_tensor(v, dtype=dtype).to(device)
    return out


def make_pool(seed: int, scene_cfg: Dict, pool: int, mean_noise: float,
              device) -> List[Dict]:
    """``pool`` entries {clean, noisy, n_valid}: the clean scene (the ground
    truth's source) and the request's input, the clean scene with its means
    moved by ``mean_noise`` times a standard normal draw."""
    sizes = pool_sizes(scene_cfg["n_valid_min"], scene_cfg["n_valid_max"],
                       pool)
    order = np.random.default_rng([seed, 1]).permutation(pool)
    entries = []
    for i in range(pool):
        rng = np.random.default_rng([seed, 2, i])
        n_valid = sizes[int(order[i])]
        clean = random_scene(rng, scene_cfg["pad_to"],
                             scene_cfg["sh_degree"], n_valid)
        noisy = dict(clean)
        noisy["means"] = clean["means"] + mean_noise * rng.normal(
            size=clean["means"].shape)
        entries.append({"clean": to_device(clean, device),
                        "noisy": to_device(noisy, device),
                        "n_valid": n_valid})
    return entries


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


def orbit_cameras(n_views: int, height: int, width: int, radius: float,
                  elevation_deg: float, device,
                  target: Sequence[float] = (0.5, 0.5, 0.5)) -> Dict:
    """A ring of cameras orbiting the unit-cube centre: {c2w (V, 3, 4), fx,
    fy, cx, cy (V,), width, height}, focal 1.2 max(height, width)."""
    target = np.asarray(target, dtype=np.float64)
    focal = 1.2 * max(height, width)
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
    return {"c2w": c2w.to(device), "fx": (ones * focal).to(device),
            "fy": (ones * focal).to(device),
            "cx": (ones * (width / 2.0)).to(device),
            "cy": (ones * (height / 2.0)).to(device),
            "width": width, "height": height}


def backgrounds(seed: int, kind: str, pool: int, device) -> List[torch.Tensor]:
    """One (3,) background a pool scene: black, or a colour drawn from the
    seed."""
    if kind == "black":
        return [torch.zeros(3, device=device) for _ in range(pool)]
    if kind != "random":
        raise ValueError(f"background {kind!r}")
    rng = np.random.default_rng([seed, 3])
    return [torch.as_tensor(rng.uniform(size=3), dtype=torch.float32
                            ).to(device) for _ in range(pool)]
