"""Fit a per-scene 3DGS from a COLMAP capture on the card (port of
scripts/fit_3dgs.py; the stage the reference's data generator runs
splatfacto for).

Reads <scene>/sparse/0 and <scene>/images, normalises the scene to the unit
cube with the dataset's ratio-preserving MinMax scaler
(data/transforms.py), fits it with training/fit_gs.py, and writes the
scene npz cache that data/nerfstudio.py:load_scene_npz reads (the schema of
prepare_data).

    python -m splatformer_tpu_torch.fit_3dgs --colmap data/colmap/scene0 \\
        --out cache/scene0.npz --steps 4000

Runs on the card unless ``--cpu`` is given; without ``--cpu`` and without a
card it exits with status 1. ``--ply`` (the viewer export,
utils/viewer.py) is not ported yet and is refused by name (ROADMAP.md
queue 1 item 5).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--colmap", required=True,
                    help="scene dir with images/ and sparse/0")
    ap.add_argument("--out", required=True, help="output scene npz")
    ap.add_argument("--ply", default=None, help="viewer PLY path (not ported)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--capacity", type=int, default=2 ** 17)
    ap.add_argument("--sh_degree", type=int, default=1)
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--max_intersects", type=int, default=2 ** 19)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.ply:
        raise NotImplementedError("--ply (utils/viewer.py) is not ported yet "
                                  "(ROADMAP.md queue 1 item 5)")
    if not args.cpu and not torch.cuda.is_available():
        print("fit_3dgs: no CUDA device is available (pass --cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")

    from splatformer_tpu_torch.data import colmap as colmap_io
    from splatformer_tpu_torch.data.dataset import read_image
    from splatformer_tpu_torch.data.nerfstudio import load_cameras_colmap
    from splatformer_tpu_torch.data.transforms import MinMaxScaler
    from splatformer_tpu_torch.ops.types import Camera, RasterizeConfig
    from splatformer_tpu_torch.training import fit_gs

    meta, train_paths, test_paths = load_cameras_colmap(args.colmap)
    _, _, points3d = colmap_io.read_model(
        os.path.join(args.colmap, "sparse", "0"))
    pts = np.stack([p.xyz for p in points3d.values()]).astype(np.float32) \
        if points3d else None
    cols = (np.stack([p.rgb for p in points3d.values()]) / 255.0
            ).astype(np.float32) if points3d else None

    # the scene and its cameras into the unit cube (GS.py:190-198)
    scaler = MinMaxScaler()
    if pts is not None and len(pts) > 32:
        pts = scaler.fit_transform(pts)
    else:
        scaler.fit_transform(meta["train_camera_to_worlds"][:, :3, 3].copy())
        pts, cols = None, None
    for key in ("train_camera_to_worlds", "test_camera_to_worlds"):
        if len(meta[key]):
            meta[key] = np.asarray(meta[key], np.float32)
            meta[key][:, :3, -1] = scaler.transform(meta[key][:, :3, -1])

    d = max(args.downscale, 1)
    bg = np.zeros(3, np.float32)
    imgs = np.stack([read_image(p, bg)[::d, ::d] for p in train_paths])
    height, width = imgs.shape[1], imgs.shape[2]
    c2w = meta["train_camera_to_worlds"][:, :3, :4]
    v = c2w.shape[0]

    def full(x):
        return torch.full((v,), float(x), dtype=torch.float32, device=device)
    cameras = Camera(c2w=torch.from_numpy(np.ascontiguousarray(c2w)).to(
        device), fx=full(meta["fx"] / d), fy=full(meta["fy"] / d),
        cx=full(meta["cx"] / d), cy=full(meta["cy"] / d),
        width=width, height=height)
    images = torch.from_numpy(np.ascontiguousarray(imgs[..., :3])).to(device)

    cfg = fit_gs.FitConfig(steps=args.steps, capacity=args.capacity,
                           sh_degree=args.sh_degree)
    rcfg = RasterizeConfig(max_intersects=args.max_intersects)
    scene, metrics = fit_gs.fit_gaussians(
        images, cameras, cfg, rcfg, points=pts, colors=cols, seed=args.seed,
        log_every=args.log_every)
    final = fit_gs.eval_fit(scene, images, cameras, rcfg)
    print("fit:", metrics, "train-view:", final, flush=True)

    # the live Gaussians, in the dataset's npz schema
    mask = scene.mask.cpu().numpy()
    gs = {k: getattr(scene, k).cpu().numpy()[mask] for k in fit_gs.ATTRS}
    flat = {f"gs/{k}": v for k, v in gs.items()}
    flat.update({f"meta/{k}": np.asarray(v) for k, v in meta.items()})
    flat["scene_name"] = np.asarray(os.path.basename(args.colmap.rstrip("/")))
    flat["train_imgs_path"] = np.asarray(train_paths)
    flat["test_imgs_path"] = np.asarray(test_paths)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **flat)
    print("wrote", args.out, f"({int(mask.sum())} gaussians)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
