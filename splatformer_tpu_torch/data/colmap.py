"""COLMAP sparse-reconstruction I/O (copy of splatformer_tpu/data/colmap.py),
numpy and struct after the COLMAP file-format spec
(colmap.github.io/format.html): text and binary readers and writers for
cameras, images and points3D, quaternion <-> rotation conversions, and the
camera-model parameters parsed into a nerfstudio-style intrinsics dict.
Files written by this module and by the JAX package's are byte-identical.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS: Dict[int, Tuple[str, int]] = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NUM_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray       # (4,) wxyz
    tvec: np.ndarray       # (3,)
    camera_id: int
    name: str
    xys: np.ndarray        # (P, 2)
    point3D_ids: np.ndarray  # (P,)


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP scalar-first (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> scalar-first quaternion (largest-eigenvector
    method, matching COLMAP's convention incl. sign normalization)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# --------------------------------------------------------------------------
# binary readers
# --------------------------------------------------------------------------

def _read(fid, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<i8")])
            out[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"),
                np.stack([data["x"], data["y"]], axis=-1) if npts else
                np.zeros((0, 2)),
                data["id"].copy())
    return out


def read_points3D_binary(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (tl,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * tl),
                                  dtype=[("img", "<i4"), ("p2d", "<i4")])
            out[pid] = ColmapPoint3D(pid, xyz, rgb, float(err),
                                     track["img"].copy(), track["p2d"].copy())
    return out


# --------------------------------------------------------------------------
# text readers
# --------------------------------------------------------------------------

def _text_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _text_lines(path):
        el = line.split()
        cam_id = int(el[0])
        out[cam_id] = ColmapCamera(cam_id, el[1], int(el[2]), int(el[3]),
                                   np.array([float(x) for x in el[4:]]))
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    # keep empty lines: every image owns exactly two lines, and the 2nd
    # (points2D) may be empty
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if not l.startswith("#")]
    for i in range(0, len(lines) - len(lines) % 2, 2):
        if not lines[i].strip():
            continue
        el = lines[i].split()
        img_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(x) for x in pts]).reshape(-1, 3) if pts else \
            np.zeros((0, 3))
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name,
                                  xys[:, :2], xys[:, 2].astype(np.int64))
    return out


def read_points3D_text(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in _text_lines(path):
        el = line.split()
        pid = int(el[0])
        xyz = np.array([float(x) for x in el[1:4]])
        rgb = np.array([int(x) for x in el[4:7]])
        err = float(el[7])
        track = np.array([int(x) for x in el[8:]]).reshape(-1, 2)
        out[pid] = ColmapPoint3D(pid, xyz, rgb, err, track[:, 0], track[:, 1])
    return out


# --------------------------------------------------------------------------
# writers (round-trip support, used by tests and data prep)
# --------------------------------------------------------------------------

def write_cameras_binary(cameras: Dict[int, ColmapCamera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_cameras_text(cameras: Dict[int, ColmapCamera], path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, ColmapImage], path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        for im in images.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(f"{x} {y} {int(pid)}" for (x, y), pid in
                           zip(im.xys, im.point3D_ids))
            f.write(pts + "\n")


def write_points3D_binary(points3D: Dict[int, ColmapPoint3D], path):
    """Binary points3D writer (reference colmap_utils.py:383-411 parity)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points3D)))
        for pt in points3D.values():
            f.write(struct.pack("<Q", pt.id))
            f.write(struct.pack("<3d", *np.asarray(pt.xyz, np.float64)))
            f.write(struct.pack("<3B", *np.asarray(pt.rgb, np.uint8)))
            f.write(struct.pack("<d", float(pt.error)))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for img_id, p2d in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(img_id), int(p2d)))


def write_points3D_text(points3D: Dict[int, ColmapPoint3D], path):
    """Text points3D writer (reference colmap_utils.py:356-380 parity)."""
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pt in points3D.values():
            xyz = " ".join(repr(float(x)) for x in pt.xyz)
            rgb = " ".join(str(int(c)) for c in pt.rgb)
            track = " ".join(f"{int(i)} {int(p)}" for i, p in
                             zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {repr(float(pt.error))} {track}\n")


def write_model(cameras: Dict[int, ColmapCamera],
                images: Dict[int, ColmapImage],
                points3D: Dict[int, ColmapPoint3D], path, ext: str = ".bin"):
    """Write a full sparse model dir (reference colmap_utils.py:436-446)."""
    path = Path(path)
    os.makedirs(path, exist_ok=True)
    writers = {
        ".bin": (write_cameras_binary, write_images_binary,
                 write_points3D_binary),
        ".txt": (write_cameras_text, write_images_text, write_points3D_text),
    }[ext]
    writers[0](cameras, path / f"cameras{ext}")
    writers[1](images, path / f"images{ext}")
    writers[2](points3D, path / f"points3D{ext}")


def read_model(path, ext: str = ""):
    path = Path(path)
    if not ext:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    readers = {
        ".bin": (read_cameras_binary, read_images_binary, read_points3D_binary),
        ".txt": (read_cameras_text, read_images_text, read_points3D_text),
    }[ext]
    cameras = readers[0](path / f"cameras{ext}")
    images = readers[1](path / f"images{ext}")
    p3d_path = path / f"points3D{ext}"
    points = readers[2](p3d_path) if os.path.exists(p3d_path) else {}
    return cameras, images, points


def parse_colmap_camera_params(camera: ColmapCamera) -> dict:
    """ColmapCamera -> nerfstudio-style intrinsics dict (fl_x/fl_y/cx/cy/w/h
    + distortion + camera_model), covering all COLMAP models like the
    reference's parse_colmap_camera_params (colmap_utils.py:490-682)."""
    p = camera.params
    out = {"w": camera.width, "h": camera.height,
           "camera_model": camera.model,
           "k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0, "p1": 0.0, "p2": 0.0}
    m = camera.model
    if m == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif m == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif m == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif m == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif m == "OPENCV":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], p1=p[6], p2=p[7])
    elif m == "OPENCV_FISHEYE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], k3=p[6], k4=p[7])
    elif m == "FULL_OPENCV":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], p1=p[6], p2=p[7], k3=p[8], k4=p[9])
    elif m == "FOV":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3], k1=p[4])
    elif m in ("SIMPLE_RADIAL_FISHEYE",):
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif m in ("RADIAL_FISHEYE",):
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif m == "THIN_PRISM_FISHEYE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], p1=p[6], p2=p[7], k3=p[8], k4=p[9])
    else:
        raise NotImplementedError(m)
    out = {k: (float(v) if isinstance(v, (np.floating, float)) else v)
           for k, v in out.items()}
    return out
