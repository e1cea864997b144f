"""Merge-rate quality sweep on a trained checkpoint (port of
scripts/eval_sweep_r4.py), the token-merging efficiency study: every
merging and downsampling algorithm x rate on the held-out test scenes,
one row each in eval.csv's schema ('dataset,psnr,ssim,lpips,algo,r,max
mem'), plus the ``input`` (the unrefined scenes) and ``base`` (the trained
model, no reduction) rows.

    # on the card, from a run of python -m splatformer_tpu_torch.train
    python -m splatformer_tpu_torch.eval_sweep --run output/scale \\
        --dataset oodbench_scale --pad 16384

    # the CPU, tiny (a --cpu run of the train CLI with the same overrides)
    python -m splatformer_tpu_torch.eval_sweep --cpu --run output/tiny \\
        --dataset synthetic --pad 1024 --override ... --rates 0.5

The merging and downsampling configs add no parameter, so the run's one
checkpoint (checkpoints_best, else checkpoints) serves every combination.
Test scenes are truncated and padded to ``--pad`` Gaussians (the
reference's max_gs_num truncation). The mappings of the JAX script:

  * merge algorithms ride their ``ptv3_<algo>`` config with
    ``additional_info.r`` = r; ALGM's threshold is 1 - r;
  * the ToMeSD modes (random_patch, progressive, important_patch) ride
    ``ptv3_tome`` with ``tome`` = the mode;
  * fps and drop keep the fraction 1 - r (``downsample_ratio``);
  * voxel's edge is 0.0075 (1 + 2r), its capacity the largest exact count
    of occupied voxels over the test scenes, plus 256.

Rows go to ``--csv`` (default output/eval_sweep.csv, never the repo's
eval.csv); combinations already there under the same dataset tag are
skipped, so a cut sweep continues. A combination that raises is reported
and the process exits 1 at the end. Each combination prints a JSON line
with its seconds; fps's also has the FPS loop's ms on the first scene.
Runs on the card unless ``--cpu``; without a card it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch

MERGE_ALGOS = ("tome", "pitome", "tofu", "prune", "patch", "wpatch", "algm")
# ToMeSD-family modes: no config of their own, they ride ptv3_tome
TOMESD_ALGOS = ("random_patch", "progressive", "important_patch")
DOWN_ALGOS = ("fps", "voxel", "drop")
RATES = (0.1, 0.3, 0.5, 0.7, 0.9)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True,
                   help="training output dir (checkpoints_best/ preferred)")
    p.add_argument("--dataset", default="oodbench_scale")
    p.add_argument("--pad", type=int, default=16384)
    p.add_argument("--csv", default="output/eval_sweep.csv")
    p.add_argument("--rates", default=",".join(str(r) for r in RATES))
    p.add_argument("--max_scenes", type=int, default=0,
                   help="cap the test-scene count (0 = all)")
    p.add_argument("--algos",
                   default=",".join(MERGE_ALGOS + TOMESD_ALGOS + DOWN_ALGOS))
    p.add_argument("--override", action="append", default=[],
                   help="config override a.b.c=value (repeatable), as the "
                        "run was trained with")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def max_occupied_voxels(scenes, voxel_size: float) -> int:
    """The most occupied voxels of edge ``voxel_size`` in any scene (the
    downsampler's int32 key, on the host)."""
    most = 0
    for _, sb in scenes:
        m = sb.scene.means[sb.scene.valid_mask()].cpu().numpy()
        v = np.floor(m / voxel_size).astype(np.int64)
        key = v[:, 0] * 1_000_000 + v[:, 1] * 1_000 + v[:, 2]
        most = max(most, len(np.unique(key)))
    return most


def variant_info(algo: str, r: float, info: dict, scenes, pad: int) -> dict:
    """``info`` (the algorithm's config's additional_info) set for rate r,
    with the JAX script's mappings."""
    info = dict(info)
    if algo in TOMESD_ALGOS:
        info.update(tome=algo, r=r)
    elif algo in MERGE_ALGOS:
        info["r"] = r
        if algo == "algm":
            info["threshold"] = round(1.0 - r, 4)
    elif algo in ("fps", "drop"):
        info["downsample_ratio"] = round(1.0 - r, 4)
    elif algo == "voxel":
        vs = round(0.0075 * (1.0 + 2.0 * r), 6)
        most = max_occupied_voxels(scenes, vs)
        info.update(voxel_size=vs,
                    voxel_capacity_factor=min(1.0, (most + 256) / pad))
    else:
        raise ValueError(f"unknown algorithm {algo!r}")
    return info


def fps_loop_ms(scene, ratio: float) -> float:
    """Milliseconds of the FPS loop alone on ``scene`` at ``ratio``
    (synchronised on the card)."""
    from splatformer_tpu_torch.ops.downsample import furthest_point_sampling
    mask = scene.valid_mask()
    m = max(1, int(scene.num_points * ratio))
    if mask.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    furthest_point_sampling(scene.means, mask, m)
    if mask.is_cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("eval_sweep: no CUDA device is available (pass --cpu to run "
              "on the CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")

    from splatformer_tpu_torch.configs import build_full_config
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.models.lpips import make_lpips_fn
    from splatformer_tpu_torch.ops.calibrate import (calibrate_raster_config,
                                                     calibration_summary)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training import checkpoints as ckpt_lib
    from splatformer_tpu_torch.training.loop import (build_train_state,
                                                     make_splatfacto_data,
                                                     make_synthetic_data)
    from splatformer_tpu_torch.training.train_step import make_eval_step
    from splatformer_tpu_torch.utils.logging import (device_peak_memory_mb,
                                                     log_result_csv)

    overrides = list(args.override) + [f"dataset.max_gs_num={args.pad}",
                                       f"dataset.pad_to={args.pad}"]

    def config(model_name):
        return build_full_config(model_name, args.dataset, "default",
                                 overrides)

    cfg = config("ptv3_base")
    rcfg = RasterizeConfig()
    if getattr(cfg.dataset, "synthetic", False):
        _, test_factories = make_synthetic_data(cfg.dataset, rcfg, device)
    else:
        _, test_factories = make_splatfacto_data(cfg.dataset, device)
    name0 = next(iter(test_factories))
    scenes = test_factories[name0]()
    if args.max_scenes:
        scenes = scenes[:args.max_scenes]
    if cfg.train.auto_raster_budget and not getattr(cfg.dataset, "synthetic",
                                                    False):
        rcfg = calibrate_raster_config(
            [(sb.scene, sb.cameras) for _, sb in scenes], rcfg)
    print(f"{len(scenes)} test scenes at pad {args.pad}; raster "
          f"{calibration_summary(rcfg)}", flush=True)

    base_model = build_feature_predictor(cfg.model, device=device,
                                         seed=cfg.train.seed)
    state = build_train_state(cfg, base_model, device)
    best_dir = os.path.join(args.run, "checkpoints_best")
    ck = (best_dir if ckpt_lib.latest_step(best_dir) is not None
          else os.path.join(args.run, "checkpoints"))
    if ckpt_lib.latest_step(ck) is None:
        print(f"eval_sweep: no checkpoint under {args.run}", file=sys.stderr)
        return 1
    state = ckpt_lib.restore_checkpoint(ck, state)
    print(f"checkpoint: {ck} step {state.step}", flush=True)
    weights = base_model.state_dict()
    lpips_fn = make_lpips_fn(cfg.train.lpips_weights_path, device)

    def evaluate(model, tag):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        step = make_eval_step(model, rcfg, render_input=model is None)
        t0 = time.perf_counter()
        ps, ss, lp = [], [], []
        for _, sb in scenes:
            rgb, _, psnr, ssim, _ = step(sb)
            ps.append(float(psnr.mean()))
            ss.append(float(ssim.mean()))
            if lpips_fn is not None:
                with torch.inference_mode():
                    lp.append(float(lpips_fn(rgb, sb.images).mean()))
        m = {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}
        if lp:
            m["lpips"] = float(np.mean(lp))
        m["seconds"] = time.perf_counter() - t0
        m["max_mem"] = device_peak_memory_mb(device)
        print(json.dumps({"combination": tag, **m}), flush=True)
        return m

    dataset_tag = f"{name0}-pad{args.pad}"
    done = set()
    if os.path.exists(args.csv):
        with open(args.csv) as f:
            for line in f.readlines()[1:]:
                parts = line.strip().split(",")
                if len(parts) >= 6 and parts[0] == dataset_tag:
                    done.add((parts[4], parts[5]))
    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)

    def row(algo, r, m):
        log_result_csv(args.csv, dataset_tag, m, algo=algo, r=r,
                       max_mem=m["max_mem"])

    if ("input", "0.0") not in done:
        row("input", 0.0, evaluate(None, "input"))
    if ("base", "0.0") not in done:
        row("base", 0.0, evaluate(base_model, "base"))

    failed = []
    for algo in args.algos.split(","):
        for r in (float(x) for x in args.rates.split(",")):
            if (algo, str(r)) in done:
                print(f"[skip] {algo} r={r}", flush=True)
                continue
            try:
                mcfg = config(f"ptv3_{algo}" if algo not in TOMESD_ALGOS
                              else "ptv3_tome").model
                mcfg.additional_info = variant_info(
                    algo, r, mcfg.additional_info, scenes, args.pad)
                model = build_feature_predictor(mcfg, device=device)
                model.load_state_dict(weights)
                if algo == "fps":
                    print(json.dumps({"fps_loop_ms": fps_loop_ms(
                        scenes[0][1].scene,
                        mcfg.additional_info["downsample_ratio"]),
                        "r": r}), flush=True)
                m = evaluate(model, f"{algo} r={r}")
            except Exception:  # noqa: BLE001 - report, go on, exit 1
                print(f"FAILED {algo} r={r}:\n{traceback.format_exc()}",
                      file=sys.stderr, flush=True)
                failed.append(f"{algo} r={r}")
                continue
            row(algo, r, m)

    if failed:
        print(f"eval_sweep: {len(failed)} combinations failed: "
              f"{', '.join(failed)}", file=sys.stderr)
        return 1
    print("sweep complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
