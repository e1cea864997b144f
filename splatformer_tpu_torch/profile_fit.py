"""Where the time of one per-scene fit step goes on the card.

    python -m splatformer_tpu_torch.profile_fit   # needs a GPU

Builds one scene of the scale tier as make_ood_benchmark does with
scripts/run_oodbench_scale.sh's flags (98,304 ground-truth Gaussians, 14
input views at 256^2, a 65,536-slot fit seeded from 49,152 input-visible
points, max_intersects 524,288, tiers 8,32768,24,4096), runs 20 warm-up
fit steps, then prints JSON lines:
  steps     host-clock ms of each of 50 fit steps, each ended by a
            synchronize (median, min, max);
  profile   torch.profiler over 20 fit steps: the wall time, the summed
            device time of all kernels, the device's busy share, kernel
            launches a step, K1's and K2's device ms a step, and the ten
            kernels with the most device time;
and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

TIMED, PROFILED, WARMUP = 50, 20, 20


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_ms(kernels, part: str) -> float:
    """Summed device ms of the profiled kernels whose name holds ``part``."""
    return sum(_device_time_us(e) for e in kernels if part in e.key) / 1e3


def main() -> None:
    from splatformer_tpu_torch.data.procgen import make_gt_scene, ring_cameras
    from splatformer_tpu_torch.make_ood_benchmark import (SH_C0,
                                                          sfm_like_seed_points)
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training import fit_gs

    rcfg = RasterizeConfig(max_intersects=524_288, tiers=(8, 32768, 24, 4096))
    cfg = fit_gs.FitConfig(steps=500, capacity=65_536, warmup_steps=100,
                           densify_every=100, densify_stop=333,
                           densify_budget_frac=0.08, reset_opacity_every=0,
                           sh_degree=1, sh_degree_interval=125,
                           lr_means=8e-4, lr_means_final=4e-5)
    gt = make_gt_scene(0, n_gauss=98_304)
    cams = ring_cameras([0.0, 10.0], 7, 256, 256, az_jitter=0.15, seed=0)
    bg = torch.zeros(3, device="cuda")
    with torch.no_grad():
        images = torch.clamp(render_images(gt, cams, bg, rcfg)[0], 0.0, 1.0)
    pts, cols, _ = sfm_like_seed_points(
        gt.means.cpu().numpy(), gt.features_dc.cpu().numpy() * SH_C0 + 0.5,
        cams, 256, 49_152, 0)
    state = fit_gs.init_state(cfg, points=pts, colors=cols, seed=0)
    band = torch.ones(3, device="cuda")
    views = [cams.select(i) for i in range(14)]

    def step(i):
        fit_gs.fit_step(cfg, rcfg, state, views[i % 14], images[i % 14], bg,
                        band)

    for i in range(WARMUP):
        step(i)
    torch.cuda.synchronize()
    ms = []
    for i in range(TIMED):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"phase": "steps", "steps": TIMED,
                      "median_ms": float(np.median(ms)),
                      "min_ms": min(ms), "max_ms": max(ms),
                      "live_gaussians": int(state.mask.sum())}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_time_us(e) > 0]
    kernels.sort(key=_device_time_us, reverse=True)
    device_ms = sum(_device_time_us(e) for e in kernels) / 1e3

    print(json.dumps({
        "phase": "profile", "steps": PROFILED, "wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": (device_ms / wall_ms if kernels
                              else "not measured"),
        "launches_per_step": sum(e.count for e in kernels) / PROFILED,
        "k1_ms_per_step": kernel_ms(kernels, "composite_fwd_kernel")
        / PROFILED,
        "k2_ms_per_step": kernel_ms(kernels, "composite_bwd_kernel")
        / PROFILED,
        "top_kernels": [{"name": e.key[:90], "ms": _device_time_us(e) / 1e3,
                         "calls": e.count} for e in kernels[:10]]}),
        flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit needs an NVIDIA GPU")
    main()
