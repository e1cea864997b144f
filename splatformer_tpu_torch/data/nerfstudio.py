"""Nerfstudio / splatfacto checkpoint and camera loading (port of
splatformer_tpu/data/nerfstudio.py; the reference's dataset/GS.py:153-244).

Read the newest ``nerfstudio_models/step-*.ckpt``, strip
``_model.gauss_params.``, drop NaN rows, optionally remove n-sigma
outliers, truncate to max_gs_num, MinMax-normalise the means (with the
log-scale correction), drop inf and out-of-range rows; load the cameras
from the pickled ``camera_for-3d-denoise.pkl`` or from the COLMAP sparse
model. Everything is numpy on the host; ``convert_scene_to_npz`` writes a
pickle-free cache for fast reloads.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

import torch

from splatformer_tpu_torch.data import colmap as colmap_io
from splatformer_tpu_torch.data.transforms import MinMaxScaler, remove_outliers

GS_KEYS = ("means", "scales", "quats", "opacities", "features_dc",
           "features_rest")


def load_gauss_params_ckpt(nerfstudio_dir: str) -> Dict[str, np.ndarray]:
    """Read raw gauss_params from the newest step-*.ckpt (torch pickle)."""
    ckpts = sorted(glob.glob(os.path.join(
        nerfstudio_dir, "nerfstudio_models", "step-*.ckpt")))
    if not ckpts:
        raise FileNotFoundError(
            f"{nerfstudio_dir} has no nerfstudio_models/step-*.ckpt")
    ckpt = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    if "pipeline" in ckpt:
        ckpt = ckpt["pipeline"]
    out = {}
    for k, v in ckpt.items():
        if "gauss_params" in k:
            out[k.split("gauss_params.")[-1]] = v.detach().numpy()
    return out


def prepare_gs_params(raw: Dict[str, np.ndarray],
                      keys: Tuple[str, ...] = GS_KEYS,
                      remove_outlier_ndevs: float = -1.0,
                      max_gs_num: int = 100_000
                      ) -> Tuple[Dict[str, np.ndarray], MinMaxScaler]:
    """Filter + normalize (GS.py:166-204). Returns (params, scaler)."""
    gs = {k: np.asarray(raw[k], np.float32) for k in keys if k in raw}

    select = np.ones(gs["means"].shape[0], bool)
    for k, v in gs.items():
        if v.ndim == 3:
            select &= ~np.isnan(v.sum(axis=1)).any(axis=1)
        else:
            select &= ~np.isnan(v).any(axis=1)
    gs = {k: v[select] for k, v in gs.items()}

    if remove_outlier_ndevs > 0:
        _, inlier = remove_outliers(gs["means"], n_devs=remove_outlier_ndevs)
        gs = {k: v[inlier] for k, v in gs.items()}

    if gs["means"].shape[0] > max_gs_num:
        gs = {k: v[:max_gs_num] for k, v in gs.items()}

    scaler = MinMaxScaler()
    gs["means"] = scaler.fit_transform(gs["means"])
    gs["scales"] = gs["scales"] + np.log(scaler.scale_)

    valid = ~np.isinf(gs["scales"]).any(axis=1)
    valid &= np.all((gs["means"] >= 0) & (gs["means"] <= 1), axis=1)
    gs = {k: v[valid] for k, v in gs.items()}
    return gs, scaler


def load_cameras_nerfstudio(nerfstudio_dir: str, colmap_dir: str
                            ) -> Tuple[dict, List[str], List[str]]:
    """Pickled camera meta + train/test image-path split (GS.py:206-244):
    'elevation' files are OOD test (only 70/80/90 kept), 'test'/'frame_eval'
    prefixes are test, everything else train; optional ood-test_split.txt."""
    with open(os.path.join(nerfstudio_dir, "camera_for-3d-denoise.pkl"),
              "rb") as f:
        meta = pickle.load(f)
    meta = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in meta.items()}

    image_names = sorted(os.listdir(os.path.join(colmap_dir, "images")))
    split_file = os.path.join(colmap_dir, "ood-test_split.txt")
    ood_names = None
    if os.path.isfile(split_file):
        with open(split_file) as f:
            ood_names = [l.strip() for l in f if l.strip()]

    train_paths, test_paths = [], []
    testset_elevation = False
    for name in image_names:
        path = os.path.join(colmap_dir, "images", name)
        if "elevation" in name:
            testset_elevation = True
            if any(f"elevation{e}" in name for e in (70, 80, 90)):
                test_paths.append(path)
        elif name.startswith("test") or name.startswith("frame_eval"):
            test_paths.append(path)
        else:
            train_paths.append(path)
    if testset_elevation:
        meta["test_camera_to_worlds"] = meta["test_camera_to_worlds"][-9:]
    if ood_names is not None:
        ids = [i for i, p in enumerate(test_paths)
               if os.path.basename(p) in ood_names]
        test_paths = [test_paths[i] for i in ids]
        meta["test_camera_to_worlds"] = meta["test_camera_to_worlds"][ids]
    return meta, train_paths, test_paths


def load_cameras_colmap(colmap_dir: str) -> Tuple[dict, List[str], List[str]]:
    """COLMAP sparse/0 -> OpenGL c2w + intrinsics meta (GS.py:246-306)."""
    recon = os.path.join(colmap_dir, "sparse", "0")
    cameras, images, _ = colmap_io.read_model(recon)
    assert len(cameras) == 1, "Only one camera is supported"
    cam = colmap_io.parse_colmap_camera_params(next(iter(cameras.values())))
    assert cam["camera_model"] in ("SIMPLE_PINHOLE", "PINHOLE"), \
        "Only pinhole cameras are supported"
    meta = {"fx": np.float32(cam["fl_x"]), "fy": np.float32(cam["fl_y"]),
            "cx": np.float32(cam["cx"]), "cy": np.float32(cam["cy"]),
            "width": np.float32(cam["w"]), "height": np.float32(cam["h"])}

    ordered = sorted(images.keys(), key=lambda i: images[i].name)
    c2ws, names = [], []
    for i in ordered:
        im = images[i]
        R = colmap_io.qvec2rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL
        c2ws.append(c2w.astype(np.float32))
        names.append(im.name)

    train_poses, test_poses, train_paths, test_paths = [], [], [], []
    for pose, name in zip(c2ws, names):
        path = os.path.join(colmap_dir, "images", name)
        if name.startswith("test"):
            test_poses.append(pose)
            test_paths.append(path)
        else:
            train_poses.append(pose)
            train_paths.append(path)
    if not train_poses:
        train_poses = test_poses[:1]
        train_paths = test_paths[:1]
    meta["train_camera_to_worlds"] = np.stack(train_poses)
    meta["test_camera_to_worlds"] = np.stack(test_poses)
    return meta, train_paths, test_paths


def load_scene(nerfstudio_dir: str, colmap_dir: str,
               load_pose_src: str = "nerfstudio",
               remove_outlier_ndevs: float = -1.0,
               max_gs_num: int = 100_000) -> dict:
    """Full scene load: gauss params + cameras, with camera positions pushed
    through the same MinMax scaler as the means (GS.py:308-322)."""
    raw = load_gauss_params_ckpt(nerfstudio_dir)
    gs, scaler = prepare_gs_params(
        raw, remove_outlier_ndevs=remove_outlier_ndevs, max_gs_num=max_gs_num)
    if load_pose_src == "colmap":
        meta, train_paths, test_paths = load_cameras_colmap(colmap_dir)
    elif load_pose_src == "nerfstudio":
        meta, train_paths, test_paths = load_cameras_nerfstudio(
            nerfstudio_dir, colmap_dir)
    else:
        raise ValueError(load_pose_src)
    for key in ("train_camera_to_worlds", "test_camera_to_worlds"):
        meta[key] = np.asarray(meta[key], np.float32)
        meta[key][:, :3, -1] = scaler.transform(meta[key][:, :3, -1])
    return {"gs_params": gs, "meta": meta,
            "scene_name": os.path.basename(os.path.dirname(
                nerfstudio_dir.rstrip("/"))),
            "train_imgs_path": train_paths, "test_imgs_path": test_paths,
            "scaler": scaler}


def convert_scene_to_npz(nerfstudio_dir: str, colmap_dir: str, out_path: str,
                         **kwargs) -> None:
    """Offline pickle-free cache: scene dict -> one npz."""
    scene = load_scene(nerfstudio_dir, colmap_dir, **kwargs)
    flat = {f"gs/{k}": v for k, v in scene["gs_params"].items()}
    flat.update({f"meta/{k}": v for k, v in scene["meta"].items()})
    flat["scene_name"] = np.asarray(scene["scene_name"])
    flat["train_imgs_path"] = np.asarray(scene["train_imgs_path"])
    flat["test_imgs_path"] = np.asarray(scene["test_imgs_path"])
    np.savez_compressed(out_path, **flat)


def load_scene_npz(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    gs = {k.split("/", 1)[1]: data[k] for k in data.files
          if k.startswith("gs/")}
    meta = {k.split("/", 1)[1]: data[k] for k in data.files
            if k.startswith("meta/")}
    return {"gs_params": gs, "meta": meta,
            "scene_name": str(data["scene_name"]),
            "train_imgs_path": [str(p) for p in data["train_imgs_path"]],
            "test_imgs_path": [str(p) for p in data["test_imgs_path"]]}
