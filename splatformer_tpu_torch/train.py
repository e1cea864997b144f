"""Train/eval entry point of the port (the repo-root train.py's flags).

    # train on synthetic scenes on the card
    python -m splatformer_tpu_torch.train --output_dir output/smoke --max_steps 20

    # train on the data factory's scale tier (make_ood_benchmark)
    python -m splatformer_tpu_torch.train --dataset oodbench_scale \\
        --output_dir output/scale

    # the same on the CPU at a tiny size (kernels' plain versions)
    python -m splatformer_tpu_torch.train --cpu --output_dir output/tiny \\
        --max_steps 2 --override dataset.n_gaussians=1024 ...

    # eval-only: restore checkpoints_best (or --ckpt last), score every test
    # set, append rows to ./eval.csv
    python -m splatformer_tpu_torch.train --only_eval --output_dir output/smoke \\
        --compare_with_input

    # eval-only with token merging at another rate (CLI beats config); the
    # merging and downsampling configs add no parameter, so a ptv3_base run
    # serves them all
    python -m splatformer_tpu_torch.train --model ptv3_tome --merge_rate 0.5 \\
        --only_eval --output_dir output/smoke

    # scene data parallelism over 2 processes (gloo on the CPU, NCCL on
    # one card a process)
    torchrun --nproc_per_node=2 -m splatformer_tpu_torch.train --cpu \\
        --output_dir output/dp ...

Runs on the card unless ``--cpu`` is given; without ``--cpu`` and without a
card it exits with status 1. Under torchrun every process trains and
scores its own scenes, and rank 0 writes the run's files
(training/loop.py). ``--save_viewer`` (eval-only) writes each
test scene's SIBR viewer folder and input-vs-refined ``viewer.html``
under ``<output_dir>/<eval_subdir>/<dataset>/viewer/<scene>/``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ptv3_base")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--train_config", default="default")
    p.add_argument("--output_dir", default="output/exp")
    p.add_argument("--only_eval", action="store_true")
    p.add_argument("--eval_subdir", default="test")
    p.add_argument("--merge_rate", type=float, default=None,
                   help="overrides additional_info.r (CLI > config)")
    p.add_argument("--compare_with_input", action="store_true")
    p.add_argument("--ckpt", default="best", choices=("best", "last"),
                   help="eval-only: restore the best-by-held-out-PSNR "
                        "checkpoint when one exists (default), or the last")
    p.add_argument("--save_as_single", action="store_true")
    p.add_argument("--save_viewer", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--override", action="append", default=[],
                   help="config override a.b.c=value (repeatable)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("train: no CUDA device is available (pass --cpu to run on the "
              "CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")

    import torch.distributed as dist

    from splatformer_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed)
    joined = not dist.is_initialized()
    rank, _ = maybe_initialize_distributed(device)
    joined = joined and dist.is_initialized()
    try:
        return _run(args, device, rank)
    finally:
        if joined:  # the group torchrun described, left as it was found
            dist.destroy_process_group()


def _run(args: argparse.Namespace, device: torch.device, rank: int) -> int:

    from splatformer_tpu_torch.configs import build_full_config
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.models.lpips import make_lpips_fn
    from splatformer_tpu_torch.ops.calibrate import (calibrate_raster_config,
                                                     calibration_summary)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training import checkpoints as ckpt_lib
    from splatformer_tpu_torch.training.loop import (build_train_state,
                                                     evaluation,
                                                     make_splatfacto_data,
                                                     make_synthetic_data,
                                                     run_training)
    from splatformer_tpu_torch.utils.logging import get_logger, log_result_csv

    cfg = build_full_config(args.model, args.dataset, args.train_config,
                            args.override)
    if args.merge_rate is not None:
        cfg.model.additional_info["r"] = args.merge_rate

    os.makedirs(args.output_dir, exist_ok=True)
    log_name = "train.log" if rank == 0 else f"train.rank{rank}.log"
    logger = get_logger(os.path.join(args.output_dir, log_name))
    logger.info("device: %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")

    if not args.only_eval:
        run_training(cfg, args.output_dir, max_steps=args.max_steps,
                     device=device)
        return 0

    # eval-only path
    rcfg = RasterizeConfig()
    model = build_feature_predictor(cfg.model, device=device,
                                    seed=cfg.train.seed)
    if getattr(cfg.dataset, "synthetic", False):
        _, test_factories = make_synthetic_data(cfg.dataset, rcfg, device)
    else:
        _, test_factories = make_splatfacto_data(cfg.dataset, device)
        if cfg.train.auto_raster_budget:
            first = next(iter(test_factories.values()))()
            rcfg = calibrate_raster_config(
                [(sb.scene, sb.cameras) for _, sb in first], rcfg)
            logger.info("calibrated raster budgets: %s",
                        calibration_summary(rcfg))
    state = build_train_state(cfg, model, device)
    # prefer the best-by-held-out-PSNR checkpoint (training saves one at
    # every improving eval); --ckpt last opts out
    best_dir = os.path.join(args.output_dir, "checkpoints_best")
    if args.ckpt == "best" and ckpt_lib.latest_step(best_dir) is not None:
        state = ckpt_lib.restore_checkpoint(best_dir, state)
        logger.info("eval from BEST checkpoint, step %d", state.step)
    else:
        state = ckpt_lib.restore_checkpoint(
            os.path.join(args.output_dir, "checkpoints"), state)
        logger.info("eval from step %d", state.step)

    lpips_fn = make_lpips_fn(cfg.train.lpips_weights_path, device)
    algo = cfg.model.additional_info.get("tome", "base")
    r = cfg.model.additional_info.get("r", 0.0)
    for name, factory in test_factories.items():
        metrics, metrics_input, max_mem = evaluation(
            model, factory(), rcfg,
            output_dir=os.path.join(args.output_dir, args.eval_subdir, name),
            output_gt=True, compare_with_input=args.compare_with_input,
            save_as_single=args.save_as_single, save_viewer=args.save_viewer,
            lpips_fn=lpips_fn)
        logger.info("eval %s: %s", name,
                    " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if metrics_input:
            logger.info("input 3DGS %s: %s", name,
                        " ".join(f"{k}={v:.4f}"
                                 for k, v in metrics_input.items()))
        if rank == 0:
            log_result_csv("eval.csv", name, metrics, algo=algo, r=r,
                           max_mem=max_mem)
    return 0


if __name__ == "__main__":
    sys.exit(main())
