"""Attention and MLP FLOPs profiler (port of the repo-root calflops.py):
run the backbone forward over test scenes, read the per-stage point counts
from its diagnostics, compute every block's attention and MLP GFLOPs
(utils/flops.py, the quantities the reference's fvcore hooks count),
average them over the scenes and append a row 'gflops,algo,r' to a CSV.

    # one row on the card (16,384-Gaussian synthetic scenes)
    python -m splatformer_tpu_torch.calflops --model ptv3_tome \\
        --merge_rate 0.5 --num_scenes 2 \\
        --override dataset.n_gaussians=16384 --override dataset.pad_to=16384

    # the whole sweep of gflops.csv (splatformer_tpu_torch/calflops_sweep.sh)
    OUT=output/calflops sh splatformer_tpu_torch/calflops_sweep.sh

Rows go to ``--csv`` (default output/calflops/gflops.csv; never the
repo's committed gflops.csv). ``--label`` replaces the algo column (the
sweep's 65k anchor row is ``base_65k``). ``--merge_rate`` sets
``additional_info.r``; for ALGM, whose knob is a similarity threshold, it
also sets the threshold to 1 - r. ``--ckpt`` restores a training run of
the port (checkpoints_best, else checkpoints): the GFLOPs depend on the
scenes alone, the effective-token count on the weights.

Also printed: ``torch_flop_counter_gflops``, the whole forward under
FlopCounterMode (blind to the hand-written kernels: on an enable_flash
model K3's attention is missing from it; the JAX package's XLA figure is
another count and is never compared with it), the ms a forward, and for a
merging algorithm the effective tokens over all blocks from the attention
replay (utils/attn_replay.py), appended to ``<csv stem>_tokens.csv``.
Runs on the card unless ``--cpu``; without a card it exits 1. The last
line printed is a JSON object of the row and these numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

DEFAULT_CSV = os.path.join("output", "calflops", "gflops.csv")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ptv3_base")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--merge_rate", type=float, default=None)
    p.add_argument("--num_scenes", type=int, default=10)
    p.add_argument("--csv", default=DEFAULT_CSV)
    p.add_argument("--label", default=None,
                   help="the CSV's algo column (default the config's "
                        "additional_info.tome)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--ckpt", default="",
                   help="training run dir; restores its weights, so the "
                        "data-dependent effective-token count is measured "
                        "on the trained model (the GFLOPs depend on the "
                        "scenes alone)")
    p.add_argument("--override", action="append", default=[])
    return p.parse_args(argv)


def _append(path: str, header: str, row: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(header)
        f.write(row)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    """Profile one configuration; appends its rows and returns them with
    the other measurements."""
    from splatformer_tpu_torch.configs import build_full_config
    from splatformer_tpu_torch.data.synthetic import random_scene
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops import merging
    from splatformer_tpu_torch.utils.flops import (
        ptv3_attention_mlp_gflops, stage_points_from_diagnostics,
        torch_flop_counter)

    cfg = build_full_config(args.model, args.dataset, "default",
                            args.override)
    info = cfg.model.additional_info
    if args.merge_rate is not None:
        info["r"] = args.merge_rate
        if info.get("tome") == "algm":
            # ALGM's reduction knob is the adjacency-similarity threshold:
            # the sweep's r maps onto it (lower threshold, more merges)
            info["threshold"] = 1.0 - args.merge_rate
    model = build_feature_predictor(cfg.model, device=device, seed=0)

    if getattr(cfg.dataset, "synthetic", False):
        scenes = [random_scene(np.random.default_rng(i),
                               cfg.dataset.n_gaussians,
                               sh_degree=cfg.model.sh_degree, device=device)
                  for i in range(args.num_scenes)]
    else:
        from splatformer_tpu_torch.training.loop import make_splatfacto_data
        _, test_factories = make_splatfacto_data(cfg.dataset, device)
        scenes = [b.scene for _, b in
                  next(iter(test_factories.values()))()[:args.num_scenes]]

    if args.ckpt:
        from splatformer_tpu_torch.training import checkpoints as ckpt_lib
        from splatformer_tpu_torch.training.loop import build_train_state
        state = build_train_state(cfg, model, device)
        best = os.path.join(args.ckpt, "checkpoints_best")
        ck = (best if ckpt_lib.latest_step(best) is not None
              else os.path.join(args.ckpt, "checkpoints"))
        state = ckpt_lib.restore_checkpoint(ck, state)
        model.eval()
        print(f"restored {ck} step {state.step}", flush=True)

    bk = cfg.model.backbone.backbone_kwargs()
    attn_g, mlp_g, fwd_ms = [], [], []
    with torch.inference_mode():
        for scene in scenes:
            diag: Dict[str, Any] = {}
            _sync(device)
            t0 = time.perf_counter()
            model(scene, diagnostics=diag)
            pts = stage_points_from_diagnostics(diag)  # reads the counts
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
            a, m = ptv3_attention_mlp_gflops(bk, pts, info)
            attn_g.append(a)
            mlp_g.append(m)
        counted = torch_flop_counter(model, scenes[0]) / 1e9
    attn_avg = float(np.mean(attn_g))
    mlp_avg = float(np.mean(mlp_g))
    algo = info.get("tome", "base")
    label = args.label or algo
    r = info.get("r", 0.0)
    print(f"attention GFLOPs/scene: {attn_avg:.2f}  mlp: {mlp_avg:.2f} "
          f"(algo={algo}, r={r})")
    print(f"torch_flop_counter_gflops (whole forward, no hand-written "
          f"kernel): {counted:.2f}")
    _append(args.csv, "gflops,algo,r\n", f"{attn_avg},{label},{r}\n")
    result: Dict[str, Any] = {
        "csv": args.csv, "gflops": attn_avg, "algo": label, "r": r,
        "mlp_gflops": mlp_avg, "torch_flop_counter_gflops": counted,
        "forward_ms": fwd_ms, "stage_points": pts, "scenes": len(scenes)}

    # the effective-token companion: for the data-dependent reducers (ALGM
    # above all, whose GFLOPs equal base's by design) the lever is how many
    # tokens stay live after merging, which the attention replay counts
    if (algo in merging.MERGE_MODES and float(r or 0.0) > 0.0):
        from splatformer_tpu_torch.utils.attn_replay import replay_model
        _sync(device)
        t0 = time.perf_counter()
        res = replay_model(model, scenes[0], bk, bk["enc_patch_size"][0],
                           dict(info))
        tot = sum(rec["n_tokens"] for rec in res.values())
        eff = sum(rec["n_effective_tokens"] for rec in res.values())
        ratio = eff / max(tot, 1)
        print(f"effective tokens: {eff}/{tot} = {ratio:.3f} "
              f"({len(res)} blocks)")
        tcsv = os.path.splitext(args.csv)[0] + "_tokens.csv"
        _append(tcsv, "algo,r,n_tokens,n_effective_tokens,ratio\n",
                f"{label},{r},{tot},{eff},{ratio:.4f}\n")
        result.update(tokens_csv=tcsv, n_tokens=tot, n_effective_tokens=eff,
                      token_ratio=ratio, replay_blocks=len(res),
                      replay_s=time.perf_counter() - t0)
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("calflops: no CUDA device is available (pass --cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    run(args, torch.device("cpu" if args.cpu else "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
