"""Where the time of one eval request goes on the card.

    python -m splatformer_tpu_torch.profile_eval [--flash]  # needs a GPU

Builds chip_smoke.py's serving configuration (PTv3-base at full width,
seeded random weights, one request of 100k Gaussians padded to 100352 x 4
views at 256^2; ``--flash``: enable_flash, patch 1024 through K3), then
prints JSON lines:
  stages    median ms (CUDA events, 5 runs after a warm-up) of the refine
            (FeaturePredictor), the render's entry preparation (activation,
            SH, projection, binning, gather), the compositing (K1 + untile),
            the metrics, and the whole eval step;
  profile   torch.profiler over one eval step: the summed device time of
            all kernels, the wall time, the device's busy share, the
            device time of K1 and K3-fwd, and the ten kernels with the most
            device time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def _ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def flash_flag(description: str) -> bool:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--flash", action="store_true",
                        help="PTv3-base with enable_flash (patch 1024, K3)")
    return parser.parse_args().flash


def kernel_ms(kernels, part: str) -> float:
    """Summed device ms of the profiled kernels whose name holds ``part``."""
    return sum(_device_time_us(e) for e in kernels if part in e.key) / 1e3


def main(flash: bool = False) -> None:
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops.raster import composite_packed
    from splatformer_tpu_torch.ops.render import (prepare_entries,
                                                  render_images)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training.metrics import psnr, ssim
    from splatformer_tpu_torch.training.train_step import (SceneBatch,
                                                           make_eval_step)

    cfg = get_config()
    cfg.zeroinit = False
    cfg.backbone.enable_flash = flash
    model = build_feature_predictor(cfg, device="cuda", seed=0,
                                    head_final_scale=0.01)
    scene = random_scene(np.random.default_rng(100), 100_352, sh_degree=1,
                         n_valid=100_000)
    cams = orbit_cameras(4, 256, 256)
    bg = torch.zeros(3, device="cuda")
    rcfg = RasterizeConfig()
    with torch.inference_mode():
        gt, _ = render_images(scene, cams, bg, rcfg)
        refined = model(scene)
        entries = prepare_entries(refined, cams, rcfg)
        rgb, _ = composite_packed(entries.packed_t, entries.tile_start, 256,
                                  256, 16, bg, num_images=4)
    batch = SceneBatch(scene=scene, cameras=cams, images=gt, background=bg)
    step = make_eval_step(model, rcfg)

    with torch.inference_mode():
        stages = {
            "refine_ms": _ms(lambda: model(scene)),
            "prepare_entries_ms": _ms(lambda: prepare_entries(refined, cams,
                                                              rcfg)),
            "composite_ms": _ms(lambda: composite_packed(
                entries.packed_t, entries.tile_start, 256, 256, 16, bg,
                num_images=4)),
            "metrics_ms": _ms(lambda: (psnr(rgb, gt), ssim(rgb, gt))),
            "eval_step_ms": _ms(lambda: step(batch)),
        }
    print(json.dumps({"phase": "stages", "flash": flash, **stages}),
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row also carries its kernels' time
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_time_us(e) > 0]
    kernels.sort(key=_device_time_us, reverse=True)
    device_ms = sum(_device_time_us(e) for e in kernels) / 1e3
    print(json.dumps({
        "phase": "profile", "wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "k1_ms": kernel_ms(kernels, "composite_fwd_kernel"),
        "k3_fwd_ms": kernel_ms(kernels, "attention_fwd_"),
        "top_kernels": [{"name": e.key[:90], "ms": _device_time_us(e) / 1e3,
                         "calls": e.count} for e in kernels[:10]]}),
        flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    use_flash = flash_flag("Where the time of one eval request goes.")
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs an NVIDIA GPU")
    main(use_flash)
