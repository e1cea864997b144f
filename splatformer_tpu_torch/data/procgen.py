"""Procedural ground-truth scenes for the OOD refinement benchmark (port of
splatformer_tpu/data/procgen.py).

Scenes are textured primitive shells (spheres, boxes, cylinders, tori,
cones) sampled into oriented surface splats, with a thin "canopy" above the
cluster in most scenes: its top is seen only from the high-elevation OOD
cameras. Every draw is host numpy from ``np.random.default_rng(seed)`` in
the JAX package's order, so both packages make the same scene and cameras
from one seed; the result then moves to the requested device.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from splatformer_tpu_torch.data.synthetic import look_at_c2w
from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.ops.types import Camera, GaussianScene

RGB2SH = 1.0 / 0.28209479177387814

PRIMITIVES = ("sphere", "box", "cylinder", "torus", "cone")


def _unit_surface(rng: np.random.Generator, kind: str, n: int
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """n points + outward normals on a canonical unit primitive, plus its
    surface area (used to size splats)."""
    if kind == "sphere":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        return v, v.copy(), 4.0 * math.pi
    if kind == "box":
        # pick a face per point, uniform over the 6 unit faces
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-1.0, 1.0, (n, 2))
        pts = np.zeros((n, 3))
        nrm = np.zeros((n, 3))
        for f in range(6):
            m = face == f
            ax, sign = f // 2, 1.0 if f % 2 == 0 else -1.0
            other = [a for a in range(3) if a != ax]
            pts[m, ax] = sign
            pts[m, other[0]] = uv[m, 0]
            pts[m, other[1]] = uv[m, 1]
            nrm[m, ax] = sign
        return pts, nrm, 24.0
    if kind == "cylinder":
        # side + two caps, area-weighted (r=1, h=2)
        a_side, a_cap = 2 * math.pi * 2, math.pi
        p_side = a_side / (a_side + 2 * a_cap)
        theta = rng.uniform(0, 2 * math.pi, n)
        pts = np.zeros((n, 3))
        nrm = np.zeros((n, 3))
        side = rng.uniform(size=n) < p_side
        pts[side, 0] = np.cos(theta[side])
        pts[side, 1] = np.sin(theta[side])
        pts[side, 2] = rng.uniform(-1, 1, side.sum())
        nrm[side, 0] = pts[side, 0]
        nrm[side, 1] = pts[side, 1]
        cap = ~side
        r = np.sqrt(rng.uniform(size=cap.sum()))
        sign = np.where(rng.uniform(size=cap.sum()) < 0.5, 1.0, -1.0)
        pts[cap, 0] = r * np.cos(theta[cap])
        pts[cap, 1] = r * np.sin(theta[cap])
        pts[cap, 2] = sign
        nrm[cap, 2] = sign
        return pts, nrm, a_side + 2 * a_cap
    if kind == "torus":
        # major radius 1, minor 0.35
        rr = 0.35
        u = rng.uniform(0, 2 * math.pi, n)
        v = rng.uniform(0, 2 * math.pi, n)
        # rejection-free approximation: weight by (1 + rr*cos v) is close
        # enough for splat sampling
        cx, sx = np.cos(u), np.sin(u)
        cv, sv = np.cos(v), np.sin(v)
        pts = np.stack([(1 + rr * cv) * cx, (1 + rr * cv) * sx, rr * sv], 1)
        nrm = np.stack([cv * cx, cv * sx, sv], 1)
        return pts, nrm, 4 * math.pi * math.pi * rr
    if kind == "cone":
        # apex at +z, base at -z (r=1, h=2) + base cap
        a_side = math.pi * math.sqrt(1 + 4)  # pi*r*slant
        a_cap = math.pi
        p_side = a_side / (a_side + a_cap)
        theta = rng.uniform(0, 2 * math.pi, n)
        pts = np.zeros((n, 3))
        nrm = np.zeros((n, 3))
        side = rng.uniform(size=n) < p_side
        t = np.sqrt(rng.uniform(size=side.sum()))  # area-uniform along slant
        r = t
        pts[side, 0] = r * np.cos(theta[side])
        pts[side, 1] = r * np.sin(theta[side])
        pts[side, 2] = 1.0 - 2.0 * t
        # side normal: (cos, sin, r/h slope) normalized
        nn = np.stack([np.cos(theta[side]), np.sin(theta[side]),
                       np.full(side.sum(), 0.5)], 1)
        nrm[side] = nn / np.linalg.norm(nn, axis=1, keepdims=True)
        cap = ~side
        rc = np.sqrt(rng.uniform(size=cap.sum()))
        pts[cap, 0] = rc * np.cos(theta[cap])
        pts[cap, 1] = rc * np.sin(theta[cap])
        pts[cap, 2] = -1.0
        nrm[cap, 2] = -1.0
        return pts, nrm, a_side + a_cap
    raise ValueError(kind)


def _texture(rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
    """Per-point RGB in [0,1] from a random pattern over canonical coords."""
    kind = rng.integers(0, 4)
    c0 = rng.uniform(0.1, 0.95, 3)
    c1 = rng.uniform(0.1, 0.95, 3)
    if kind == 0:  # solid + speckle
        rgb = c0[None] + rng.normal(0, 0.03, pts.shape)
    elif kind == 1:  # axis gradient + stripe modulation
        ax = rng.integers(0, 3)
        t = (pts[:, ax] - pts[:, ax].min()) / (np.ptp(pts[:, ax]) + 1e-9)
        rgb = c0[None] * (1 - t[:, None]) + c1[None] * t[:, None]
        freq = rng.uniform(4.0, 10.0)
        rgb *= (0.75 + 0.25 * (np.sin(t * freq * math.pi) > 0))[:, None]
    elif kind == 2:  # checker (high frequency: unseen regions cannot be
        # texture-interpolated by the fit, widening the OOD gap)
        freq = rng.uniform(3.0, 10.0)
        cells = np.floor(pts * freq).astype(np.int64).sum(1) % 2
        rgb = np.where(cells[:, None] == 0, c0[None], c1[None])
    else:  # stripes
        freq = rng.uniform(4.0, 14.0)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        s = (np.sin(pts @ d * freq * math.pi) > 0)
        rgb = np.where(s[:, None], c0[None], c1[None])
    return np.clip(rgb, 0.02, 0.98)


def _quat_from_normal(rng: np.random.Generator, nrm: np.ndarray) -> np.ndarray:
    """wxyz quats rotating +z to each normal: the splat's thin axis (third
    scale column) aligns with the surface normal."""
    z = nrm / (np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-12)
    # quat rotating e_z to z: axis = e_z x z, angle = acos(z_z)
    w = 1.0 + z[:, 2]
    xyz = np.stack([-z[:, 1], z[:, 0], np.zeros(len(z))], 1)
    q = np.concatenate([w[:, None], xyz], 1)
    # degenerate (z == -e_z): rotate pi about x
    bad = w < 1e-6
    q[bad] = np.array([0.0, 1.0, 0.0, 0.0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _rot_matrix(rng: np.random.Generator) -> np.ndarray:
    """Random rotation (QR of a Gaussian matrix)."""
    m = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(m)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def make_gt_scene(seed: int, n_gauss: int = 32768, sh_degree: int = 1,
                  n_primitives: Tuple[int, int] = (3, 7),
                  device="cuda") -> GaussianScene:
    """A ground-truth scene of textured primitive shells in the unit cube.

    All slots valid (mask all-True); Gaussian statistics match what the real
    pipeline produces post-normalization (means in [0,1]^3, log scales,
    opacity logits, SH color coeffs)."""
    rng = np.random.default_rng(seed)
    n_prim = int(rng.integers(n_primitives[0], n_primitives[1] + 1))
    weights = rng.uniform(0.5, 1.5, n_prim)
    weights /= weights.sum()
    counts = np.maximum((weights * n_gauss).astype(int), 64)
    counts[-1] = n_gauss - counts[:-1].sum()

    means, quats, log_scales, rgbs = [], [], [], []
    # with p=0.85 the last primitive is a thin horizontal "canopy" ABOVE the
    # cluster: its underside is visible from the input rings but its top is
    # only seen by the OOD cameras — manufacturing exactly the unseen-top
    # artifact class the reference's OOD protocol targets
    # (the reference's dataset/GS.py:222-238)
    has_canopy = bool(rng.uniform() < 0.85)
    for p in range(n_prim):
        n = int(counts[p])
        canopy = has_canopy and p == n_prim - 1
        kind = ("box" if canopy
                else PRIMITIVES[rng.integers(0, len(PRIMITIVES))])
        pts, nrm, area = _unit_surface(rng, kind, n)
        rgb = _texture(rng, pts)

        # anisotropic world placement: per-axis scale, rotation, offset
        if canopy:
            ax_scale = np.array([rng.uniform(0.18, 0.32),
                                 rng.uniform(0.18, 0.32),
                                 rng.uniform(0.008, 0.02)])
            yaw = rng.uniform(0, 2 * math.pi)
            cy_, sy_ = math.cos(yaw), math.sin(yaw)
            rot = np.array([[cy_, -sy_, 0.0], [sy_, cy_, 0.0],
                            [0.0, 0.0, 1.0]])
            center = np.array([rng.uniform(0.4, 0.6), rng.uniform(0.4, 0.6),
                               rng.uniform(0.62, 0.75)])
        else:
            ax_scale = rng.uniform(0.05, 0.16, 3) * rng.uniform(0.7, 1.3)
            rot = _rot_matrix(rng)
            # objects cluster around the cube center, slightly below middle
            # so low-elevation cameras see the sides but not the tops
            center = np.array([rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7),
                               rng.uniform(0.35, 0.6)])
        world = (pts * ax_scale) @ rot.T + center
        # normals transform by rot * inv(scale); renormalize
        wn = (nrm / ax_scale) @ rot.T
        wn /= np.linalg.norm(wn, axis=1, keepdims=True) + 1e-12

        # splat footprint from local spacing: sqrt(world area / n); the
        # anisotropic area factor is approximated by the mean pairwise
        # product of the axis scales
        s0, s1, s2 = ax_scale
        w_area = area * float(s0 * s1 + s1 * s2 + s0 * s2) / 3.0
        spacing = math.sqrt(max(w_area, 1e-8) / n)
        tangent = math.log(max(spacing * 1.1, 1e-5))
        normal_s = math.log(max(spacing * 0.15, 1e-6))
        ls = np.full((n, 3), tangent)
        ls[:, 2] = normal_s
        ls += rng.normal(0, 0.08, (n, 3))

        q = _quat_from_normal(rng, wn)
        means.append(world)
        quats.append(q)
        log_scales.append(ls)
        rgbs.append(rgb)

    means = np.clip(np.concatenate(means), 0.01, 0.99).astype(np.float32)
    quats = np.concatenate(quats).astype(np.float32)
    log_scales = np.concatenate(log_scales).astype(np.float32)
    rgb = np.concatenate(rgbs).astype(np.float32)

    sh_rest = (sh_degree + 1) ** 2 - 1
    opacities = rng.normal(3.0, 0.5, (n_gauss, 1)).astype(np.float32)
    features_dc = ((rgb - 0.5) * RGB2SH).astype(np.float32)
    features_rest = rng.normal(
        0.0, 0.02, (n_gauss, sh_rest, 3)).astype(np.float32)
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(x).to(device)
    return GaussianScene(
        means=t(means), scales=t(log_scales), quats=t(quats),
        opacities=t(opacities), features_dc=t(features_dc),
        features_rest=t(features_rest),
        mask=torch.ones(n_gauss, dtype=torch.bool, device=device))


def ring_cameras(elevations_deg, n_az: int, height: int, width: int,
                 radius: float = 1.6, target=(0.5, 0.5, 0.5),
                 focal: float | None = None, az_jitter: float = 0.0,
                 seed: int = 0, device="cuda") -> Camera:
    """Cameras on azimuth rings at the given elevations (batched Camera).

    Mirrors the reference data factory's camera layout: input rings at low
    elevation, OOD test rings at 70/80/90 degrees."""
    rng = np.random.default_rng(seed)
    target = np.asarray(target, dtype=np.float64)
    focal = focal if focal is not None else 1.2 * max(height, width)
    c2ws = []
    for elev_deg in elevations_deg:
        elev = np.deg2rad(elev_deg)
        for i in range(n_az):
            az = 2 * np.pi * i / max(n_az, 1)
            if az_jitter:
                az += rng.uniform(-az_jitter, az_jitter)
            campos = target + radius * np.array([
                np.cos(az) * np.cos(elev), np.sin(az) * np.cos(elev),
                np.sin(elev)])
            # straight-down views need a non-parallel up vector
            up = (0.0, 0.0, 1.0) if elev_deg < 89.0 else (0.0, 1.0, 0.0)
            c2ws.append(look_at_c2w(campos, target, up=up))
    device = resolve_device(device)
    v = len(c2ws)
    c2w = torch.as_tensor(np.stack(c2ws)[:, :3, :4], dtype=torch.float32)
    ones = torch.ones(v, dtype=torch.float32)
    return Camera(c2w=c2w.to(device), fx=(ones * focal).to(device),
                  fy=(ones * focal).to(device),
                  cx=(ones * (width / 2.0)).to(device),
                  cy=(ones * (height / 2.0)).to(device),
                  width=width, height=height)
