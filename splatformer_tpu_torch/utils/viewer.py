"""SIBR/Inria-viewer export: cfg_args, cameras.json, Inria-format PLY
(port of splatformer_tpu/utils/viewer.py; numpy only, and the files are
byte-identical to that module's for the same arrays).

The reference's ``prepare_viewer``, ``export_ply_forviewer`` and
``write_ply_v2`` formats, so the exported scenes load in the SIBR viewer or
any web 3DGS viewer; a binary-little-endian PLY writer of its own (no
plyfile dependency).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np

from splatformer_tpu_torch.ops.sh import rgb_to_sh


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def prepare_viewer(cameras: Dict[str, np.ndarray], dirname: str,
                   sh_degree: int) -> None:
    """Write cfg_args + cameras.json (the reference's prepare_viewer).
    ``cameras`` holds numpy arrays and python numbers."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "cfg_args"), "w") as f:
        f.write("Namespace(sh_degree={}, source_path='', "
                "white_background=False)".format(sh_degree))
    out = []
    c2ws = np.asarray(cameras["camera_to_worlds"])
    for i, c2w_opengl in enumerate(c2ws):
        cam = {
            "id": i, "img_name": f"img_{i}.png",
            "width": int(cameras["width"]), "height": int(cameras["height"]),
            "fx": float(cameras["fx"]), "fy": float(cameras["fy"]),
        }
        cam["FovX"] = focal2fov(cam["fx"], cam["width"])
        cam["FovY"] = focal2fov(cam["fy"], cam["height"])
        m = np.eye(4)
        m[:3, :4] = np.asarray(c2w_opengl)
        m[:3, 1:3] *= -1  # OpenGL -> COLMAP/OpenCV
        w2c = np.linalg.inv(m)
        # Inria viewer convention dance (stores W2C-derived pos/rot)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = R.T
        Rt[:3, 3] = T
        Rt[3, 3] = 1.0
        W2C = np.linalg.inv(Rt)
        cam["position"] = W2C[:3, 3].tolist()
        cam["rotation"] = [row.tolist() for row in W2C[:3, :3]]
        out.append(cam)
    with open(os.path.join(dirname, "cameras.json"), "w") as f:
        json.dump(out, f)


def write_ply(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Binary-little-endian PLY with float properties in dict order."""
    names = list(fields.keys())
    n = len(next(iter(fields.values())))
    data = np.stack([np.asarray(fields[k], np.float32).reshape(n)
                     for k in names], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {name}" for name in names]
        header += ["end_header", ""]
        f.write("\n".join(header).encode("ascii"))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Minimal reader for the files write_ply produces (tests/inspection)."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * n * len(names)), "<f4")
        data = data.reshape(n, len(names))
    return {name: data[:, i] for i, name in enumerate(names)}


def export_ply_for_viewer(gs_params: Dict[str, np.ndarray],
                          filename: str) -> None:
    """Inria-format PLY of raw (pre-activation) Gaussian params
    (the reference's export_ply_forviewer): x/y/z, zero normals, f_dc_*,
    f_rest_* (color-major transpose to match the Inria SH ordering),
    opacity, scale_*, rot_*. Without ``features_rest`` (or with none),
    f_dc_* is the SH coefficient of sigmoid(features_dc)."""
    gs = {k: np.asarray(v) for k, v in gs_params.items()}
    n = gs["means"].shape[0]
    fields: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        fields[ax] = gs["means"][:, i]
    for ax in ("nx", "ny", "nz"):
        fields[ax] = np.zeros(n, np.float32)
    if "features_rest" in gs and gs["features_rest"].shape[1] != 0:
        for i in range(gs["features_dc"].shape[1]):
            fields[f"f_dc_{i}"] = gs["features_dc"][:, i]
        rest = gs["features_rest"].transpose(0, 2, 1).reshape(n, -1)
        for i in range(rest.shape[1]):
            fields[f"f_rest_{i}"] = rest[:, i]
    else:
        color = 1.0 / (1.0 + np.exp(-gs["features_dc"]))
        sh0 = rgb_to_sh(color)
        for i in range(sh0.shape[1]):
            fields[f"f_dc_{i}"] = np.asarray(sh0)[:, i]
    fields["opacity"] = gs["opacities"].reshape(n)
    for i in range(3):
        fields[f"scale_{i}"] = gs["scales"][:, i]
    for i in range(4):
        fields[f"rot_{i}"] = gs["quats"][:, i]
    write_ply(filename, fields)
