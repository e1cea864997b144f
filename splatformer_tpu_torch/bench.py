"""Benchmark of the port: rasterizer forward + backward throughput and
train-step throughput on one card (the work of the repo-root bench.py and
bench_train.py).

    python -m splatformer_tpu_torch.bench [n_gauss [hw]]   # on the card
    python -m splatformer_tpu_torch.bench 1024 32 --cpu    # tiny, CPU

Work, as bench.py:86-177: ``random_scene(default_rng(0), n_gauss)`` (100k
by default) under 4 orbit views at hw^2 (256 by default), L1 against a
seeded random target, forward and backward through ``render_images`` with
the default RasterizeConfig; then a PTv3-base train step (bf16 blocks,
Adam with lr {base 1e-4, backbone 3e-5}, the default schedule over 100
steps) on the scene padded to a multiple of 1024 with random target views.
Each is timed with ``torch.cuda.synchronize`` around 10 iterations after
the warm ones (rasterizer 1, train step 4).

Prints bench.py's JSON lines to stdout: a partial line (``extra.partial``)
after the rasterizer, then the final line with the train step: ``metric``
rasterize_fwd_bwd_mrays_per_s_per_chip, ``value`` (Mrays/s = views * hw^2
over the step time), ``unit``, ``vs_baseline`` 1.0 and ``extra``: the
config, ``measured_ms``, ``peak_mem_gb``, ``device`` (the card's name and
its ``nvidia-smi`` name and power limit) and
``train_step_iters_per_s_per_chip``. Progress goes to stderr.

No MFU or roofline fields: bench.py's ``roofline()`` reads XLA's cost
analysis and utils/hbm_model.py, which have no counterpart here; counting
the step's operations and bytes is left to the benchmark's definition.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")
ITERS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gb(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _timed(fn, device: torch.device, warmup: int) -> float:
    """Seconds per call over ITERS calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / ITERS


def bench_rasterizer(n_gauss: int, hw: int, device: torch.device,
                     views: int = 4):
    """(Mrays/s, seconds a forward + backward, peak GB)."""
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    rng = np.random.default_rng(0)
    scene = random_scene(rng, n_gauss, sh_degree=1, device=device)
    cameras = orbit_cameras(views, hw, hw, device=device)
    background = torch.zeros(3, device=device)
    target = torch.as_tensor(rng.uniform(size=(views, hw, hw, 3)),
                             dtype=torch.float32).to(device)
    rcfg = RasterizeConfig()
    params = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ATTRS}

    def fwd_bwd():
        rgb, _ = render_images(scene.replace(**params), cameras, background,
                               rcfg)
        loss = torch.mean(torch.abs(rgb - target))
        return torch.autograd.grad(loss, list(params.values()))

    dt = _timed(fwd_bwd, device, warmup=1)
    return views * hw * hw / dt / 1e6, dt, _peak_gb(device)


def bench_train_step(n: int, hw: int, device: torch.device, views: int = 4):
    """(iters/s, seconds a step, peak GB, last metrics)."""
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import (SceneBatch,
                                                           make_train_step)

    rng = np.random.default_rng(0)
    n_pad = ((n + 1023) // 1024) * 1024
    scene = random_scene(rng, n_pad, sh_degree=1, n_valid=n, device=device)
    model = build_feature_predictor(get_config(), device=device,
                                    compute_dtype="bfloat16")
    opt = build_optimizer(model, {"base": 1e-4, "backbone": 3e-5},
                          total_steps=100)
    batch = SceneBatch(
        scene=scene, cameras=orbit_cameras(views, hw, hw, device=device),
        images=torch.as_tensor(rng.uniform(size=(views, hw, hw, 3)),
                               dtype=torch.float32).to(device),
        background=torch.zeros(3, device=device))
    step = make_train_step(model, opt)
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}

    def one():
        out.update(step(batch, gen))

    dt = _timed(one, device, warmup=4)
    return 1.0 / dt, dt, _peak_gb(device), {k: float(v)
                                            for k, v in out.items()}


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip()}


def result_line(mrays: float, extra: dict, partial: bool = False) -> str:
    extra = dict(extra)
    if partial:
        # the eager line lacks the train step; the last line is the result
        extra["partial"] = True
    return json.dumps({
        "metric": "rasterize_fwd_bwd_mrays_per_s_per_chip",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": 1.0,
        "extra": extra,
    })


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("n_gauss", type=int, nargs="?", default=100_000)
    p.add_argument("hw", type=int, nargs="?", default=256)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench: no CUDA device is available (pass --cpu to run on the "
              "CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda:0")
    extra = {"config": {"n_gauss": args.n_gauss, "hw": args.hw, "views": 4,
                        "model": "ptv3_base bf16"},
             "device": device_info(device)}

    mrays, dt_r, peak_r = bench_rasterizer(args.n_gauss, args.hw, device)
    log(f"rasterizer: {mrays:.3f} Mrays/s ({dt_r * 1e3:.3f} ms)")
    extra["measured_ms"] = {"rasterizer_fwd_bwd": dt_r * 1e3}
    extra["peak_mem_gb"] = {"rasterizer": peak_r}
    print(result_line(mrays, extra, partial=True), flush=True)

    iters_s, dt_t, peak_t, metrics = bench_train_step(args.n_gauss, args.hw,
                                                      device)
    log(f"train step: {iters_s:.3f} iters/s ({dt_t * 1e3:.1f} ms) {metrics}")
    extra["measured_ms"]["train_step"] = dt_t * 1e3
    extra["peak_mem_gb"]["train_step"] = peak_t
    extra["train_step_iters_per_s_per_chip"] = round(iters_s, 3)
    extra["train_step_metrics"] = metrics
    print(result_line(mrays, extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
