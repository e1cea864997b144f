"""Generate the OOD refinement benchmark on the card (port of
scripts/make_ood_benchmark.py, the reference's data-generator stage).

Per scene:
  1. build a procedural ground-truth Gaussian scene (data/procgen.py);
  2. render input views on low-elevation rings and OOD test views at
     elevations 70/80/90 (the reference's OOD protocol);
  3. fit an input 3DGS from the input views only (training/fit_gs.py): its
     high-elevation renders carry the artifacts SplatFormer learns to
     repair;
  4. write a scene folder in the layout the loaders read
     (nerfstudio/<scene>/splatfacto/nerfstudio_models/step-000001999.ckpt
     and colmap/<scene>/{images/*.png, sparse/0/*.bin}), which the JAX
     package's loaders read too.

A scene whose sparse/0/points3D.bin exists is skipped, so an interrupted
run continues where it stopped; each scene appends a row to
generation_summary.jsonl. Each scene prints its phases' seconds
(gt_scene, gt_renders, fit, eval_fit, write); the run ends with the
kernels' launch counts and, on the card, the peak device memory.

    python -m splatformer_tpu_torch.make_ood_benchmark --out data/oodbench \\
        --n_train_scenes 40 --n_test_scenes 8

Runs on the card unless ``--cpu`` is given; without ``--cpu`` and without a
card it exits with status 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def _numpy_cameras(cams):
    return {k: getattr(cams, k).detach().cpu().numpy()
            for k in ("c2w", "fx", "fy", "cx", "cy")}


def write_scene_folder(root: str, name: str, gs: dict, cams_in, cams_ood,
                       imgs_in: np.ndarray, imgs_ood: np.ndarray,
                       gt_points: np.ndarray, gt_rgb: np.ndarray) -> None:
    """Write the nerfstudio checkpoint, the COLMAP sparse model and the PNG
    images of one scene; ``gs`` holds the live Gaussians' arrays."""
    from splatformer_tpu_torch.data import colmap as cm
    from splatformer_tpu_torch.utils.logging import save_image

    ns_dir = os.path.join(root, "nerfstudio", name, "splatfacto",
                          "nerfstudio_models")
    os.makedirs(ns_dir, exist_ok=True)
    state = {f"_model.gauss_params.{k}": torch.from_numpy(np.asarray(v))
             for k, v in gs.items()}
    torch.save({"pipeline": state},
               os.path.join(ns_dir, "step-000001999.ckpt"))

    cm_dir = os.path.join(root, "colmap", name)
    img_dir = os.path.join(cm_dir, "images")
    os.makedirs(img_dir, exist_ok=True)

    def colmap_pose(c2w_gl: np.ndarray):
        c2w = np.eye(4)
        c2w[:3, :4] = c2w_gl
        c2w[0:3, 1:3] *= -1  # OpenGL -> OpenCV
        w2c = np.linalg.inv(c2w)
        return cm.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3]

    c_in, c_ood = _numpy_cameras(cams_in), _numpy_cameras(cams_ood)
    hw = imgs_in.shape[1]
    cameras = {1: cm.ColmapCamera(1, "PINHOLE", hw, hw, np.array(
        [float(c_in["fx"][0]), float(c_in["fy"][0]),
         float(c_in["cx"][0]), float(c_in["cy"][0])]))}
    images = {}
    img_id = 1
    empty = np.zeros((0, 2))
    empty_ids = np.zeros((0,), np.int64)
    for prefix, cams, imgs in (("frame_{:05d}", c_in, imgs_in),
                               ("test_{:02d}", c_ood, imgs_ood)):
        for i in range(imgs.shape[0]):
            img_name = prefix.format(i) + ".png"
            q, t = colmap_pose(cams["c2w"][i])
            images[img_id] = cm.ColmapImage(img_id, q, t, 1, img_name,
                                            empty, empty_ids)
            save_image(os.path.join(img_dir, img_name),
                       (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))
            img_id += 1

    sub = np.linspace(0, len(gt_points) - 1, min(1024, len(gt_points)),
                      dtype=int)
    points3D = {int(j) + 1: cm.ColmapPoint3D(
        int(j) + 1, gt_points[p].astype(np.float64),
        (np.clip(gt_rgb[p], 0, 1) * 255).astype(np.uint8), 0.0,
        np.zeros((0,), np.int64), np.zeros((0,), np.int64))
        for j, p in enumerate(sub)}
    cm.write_model(cameras, images, points3D,
                   os.path.join(cm_dir, "sparse", "0"), ext=".bin")


def sfm_like_seed_points(gt_means: np.ndarray, gt_rgb: np.ndarray,
                         cams_in, hw: int, n_seed: int, seed: int,
                         cell: int = 4, depth_tol: float = 0.04):
    """Subsample the ground-truth points visible from the INPUT cameras, a
    stand-in for the SfM cloud splatfacto seeds from (COLMAP's points3D see
    only input-view surface): project every point into each input camera,
    z-buffer at ``cell``-pixel granularity, keep points within
    ``depth_tol`` of the front surface in at least one view. Regions that
    only the OOD cameras see stay unseeded. Returns (points, colours,
    visible count)."""
    cams = _numpy_cameras(cams_in)
    n = len(gt_means)
    vis = np.zeros(n, bool)
    bins = hw // cell
    for i in range(cams["c2w"].shape[0]):
        c2w = np.eye(4)
        c2w[:3, :4] = cams["c2w"][i]
        c2w[0:3, 1:3] *= -1  # OpenGL -> OpenCV
        w2c = np.linalg.inv(c2w)
        pc = gt_means @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        ok = z > 1e-3
        u = np.asarray(cams["fx"][i]) * pc[:, 0] / np.maximum(z, 1e-3) \
            + np.asarray(cams["cx"][i])
        v = np.asarray(cams["fy"][i]) * pc[:, 1] / np.maximum(z, 1e-3) \
            + np.asarray(cams["cy"][i])
        bu = (u // cell).astype(np.int64)
        bv = (v // cell).astype(np.int64)
        ok &= (bu >= 0) & (bu < bins) & (bv >= 0) & (bv < bins)
        flat = np.where(ok, bv * bins + bu, 0)
        zbuf = np.full(bins * bins, np.inf, np.float32)
        np.minimum.at(zbuf, flat[ok], z[ok].astype(np.float32))
        vis |= ok & (z <= zbuf[flat] + depth_tol)
    idx = np.flatnonzero(vis)
    rng = np.random.default_rng(seed)
    if len(idx) == 0:   # degenerate scene: a uniform subsample
        idx = np.arange(n)
    take = idx[rng.integers(0, len(idx), size=n_seed)] if len(idx) < n_seed \
        else rng.choice(idx, size=n_seed, replace=False)
    jitter = rng.normal(0.0, 0.004, (n_seed, 3))
    return (gt_means[take] + jitter).astype(np.float32), \
        np.clip(gt_rgb[take], 0.0, 1.0).astype(np.float32), len(idx)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_train_scenes", type=int, default=40)
    ap.add_argument("--n_test_scenes", type=int, default=8)
    ap.add_argument("--n_gauss", type=int, default=24576,
                    help="ground-truth Gaussians per scene")
    ap.add_argument("--capacity", type=int, default=16384,
                    help="fitted-3DGS slot capacity")
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--fit_steps", type=int, default=1000)
    ap.add_argument("--n_az_in", type=int, default=7,
                    help="input azimuths per elevation ring")
    ap.add_argument("--in_elevations", default="0,10",
                    help="comma-separated input-ring elevations (deg): at "
                         "or below 10 deg with 2 rings x 7 azimuths = 14 "
                         "input views, object tops stay unconstrained and "
                         "the fitted 3DGS develops strong OOD artifacts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seed_points", type=int, default=0,
                    help="seed the fit from this many input-visible GT "
                         "points (SfM-style init, like splatfacto from "
                         "COLMAP points3D); 0 = random init")
    ap.add_argument("--densify_budget_frac", type=float, default=0.05)
    ap.add_argument("--fit_warmup", type=int, default=200)
    ap.add_argument("--max_intersects", type=int, default=2 ** 17)
    ap.add_argument("--tiers", default="",
                    help="comma tier caps 's1,k2,s2,k3' for binning (at the "
                         "65k scale tier: 8,32768,24,4096)")
    ap.add_argument("--tiles_per_gauss", type=int, default=64)
    ap.add_argument("--log_every", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def build_configs(args: argparse.Namespace):
    """(FitConfig, RasterizeConfig) of the per-scene fit and the renders."""
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training.fit_gs import FitConfig

    tiers = (tuple(int(x) for x in args.tiers.split(","))
             if args.tiers else None)
    rcfg = RasterizeConfig(max_intersects=args.max_intersects,
                           tiers=tiers, tiles_per_gauss=args.tiles_per_gauss)
    fit_cfg = FitConfig(
        steps=args.fit_steps, capacity=args.capacity,
        warmup_steps=args.fit_warmup, densify_every=100,
        densify_stop=args.fit_steps * 2 // 3,
        densify_budget_frac=args.densify_budget_frac,
        reset_opacity_every=0, sh_degree=1,
        sh_degree_interval=max(args.fit_steps // 4, 1),
        lr_means=8e-4, lr_means_final=4e-5)
    return fit_cfg, rcfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("make_ood_benchmark: no CUDA device is available (pass --cpu "
              "to run on the CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")

    from splatformer_tpu_torch.data.procgen import make_gt_scene, ring_cameras
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.training import fit_gs

    fit_cfg, rcfg = build_configs(args)
    background = torch.zeros(3, device=device)

    def render(scene, cams):
        with torch.no_grad():
            return render_images(scene, cams, background, rcfg)[0]

    splits = ([("train", args.seed + i) for i in range(args.n_train_scenes)]
              + [("test", args.seed + 10_000 + i)
                 for i in range(args.n_test_scenes)])
    summary = []
    for split, seed in splits:
        t0 = time.time()
        name = f"scene{seed:05d}"
        root = os.path.join(args.out, split)
        done_marker = os.path.join(root, "colmap", name, "sparse", "0",
                                   "points3D.bin")
        if os.path.exists(done_marker):
            print(f"[skip] {split}/{name} exists", flush=True)
            continue
        tmark = [time.time()]

        def phase(label):
            if device.type == "cuda":
                torch.cuda.synchronize()
            now = time.time()
            print(f"  [{label}: {now - tmark[0]:.3f}s]", flush=True)
            tmark[0] = now

        gt = make_gt_scene(seed, n_gauss=args.n_gauss, device=device)
        phase("gt_scene")
        # input rings stay low, so object tops are unseen and the fitted
        # 3DGS develops the OOD artifacts the refiner learns to repair
        in_elevs = [float(e) for e in args.in_elevations.split(",")]
        cams_in = ring_cameras(in_elevs, args.n_az_in, args.hw, args.hw,
                               az_jitter=0.15, seed=seed, device=device)
        cams_ood = ring_cameras([70.0, 80.0, 90.0], 3, args.hw, args.hw,
                                az_jitter=0.3, seed=seed + 1, device=device)
        imgs_in = torch.clamp(render(gt, cams_in), 0.0, 1.0)
        imgs_ood = torch.clamp(render(gt, cams_ood), 0.0, 1.0)
        phase("gt_renders")

        gt_means = gt.means.cpu().numpy()
        gt_rgb = gt.features_dc.cpu().numpy() * SH_C0 + 0.5
        seed_pts = seed_cols = None
        n_visible = 0
        if args.seed_points > 0:
            seed_pts, seed_cols, n_visible = sfm_like_seed_points(
                gt_means, gt_rgb, cams_in, args.hw, args.seed_points, seed)
        scene, fit_m = fit_gs.fit_gaussians(
            imgs_in, cams_in, fit_cfg, rcfg, seed=seed, points=seed_pts,
            colors=seed_cols, log_every=args.log_every)
        phase("fit")
        in_ood = fit_gs.eval_fit(scene, imgs_ood, cams_ood, rcfg)
        in_train = fit_gs.eval_fit(scene, imgs_in, cams_in, rcfg)
        phase("eval_fit")

        mask = scene.mask.cpu().numpy()
        gs = {k: getattr(scene, k).cpu().numpy()[mask] for k in fit_gs.ATTRS}
        write_scene_folder(root, name, gs, cams_in, cams_ood,
                           imgs_in.cpu().numpy(), imgs_ood.cpu().numpy(),
                           gt_means, gt_rgb)
        phase("write")
        row = {"split": split, "scene": name, "n_gauss": int(mask.sum()),
               "fit_psnr_input_views": round(in_train["psnr"], 3),
               "fit_psnr_ood_views": round(in_ood["psnr"], 3),
               "n_seed_visible": n_visible,
               "wall_s": round(time.time() - t0, 1)}
        summary.append(row)
        print(json.dumps(row), flush=True)
        # appended scene by scene, so an interrupted run keeps its records
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "generation_summary.jsonl"),
                  "a") as f:
            f.write(json.dumps(row) + "\n")

    print(f"wrote {len(summary)} scenes to {args.out}", flush=True)
    from splatformer_tpu_torch.kernels import LAUNCHES
    print(f"kernel launches: {json.dumps(LAUNCHES)}", flush=True)
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
