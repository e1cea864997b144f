#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one JSON line:
  build     compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  k1        the compositing kernel against its plain PyTorch version on the
            entries that the port's own binning makes for a 100k-Gaussian
            scene under 4 orbit views at 256^2 (limit 1e-5, walked counts
            exact), with its time, the plain version's and its bound;
  reference a tiny FeaturePredictor eval step on the card against the same
            step on the CPU (plain versions), same seed and weights;
  serving   PTv3-base at full width, seeded random weights (final head
            layers scaled small), answering 3 eval requests of 100k
            Gaussians (padded to 100352) x 4 views at 256^2 each: latency
            after one warm-up, PSNR/SSIM against a render of the clean scene,
            num_dropped, peak memory; every kernel's launch count over the
            3 requests must be one per request.
Then the {"kernels": [...]} line, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device it exits 1 before any phase.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

SCENE_N = 100_000
SCENE_PAD = 100_352
VIEWS, HW = 4, 256
REQUESTS = 3
K1_TOL = 1e-5
# published H100 SXM peaks (dense): FP32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations every evaluated (pixel, entry) pair needs in K1, expf
# counted as one: dx, dy, 3 products and a sum per quadratic term group
# (9), the 0.5 scale, the clamp, the negation, expf, the opacity product,
# the alpha clamp, the threshold compare
K1_OPS_PER_PAIR = 18


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, by CUDA events, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build():
    from splatformer_tpu_torch.kernels.build import (SOURCES, build_all,
                                                     library_path)
    compiled = sorted(n for n in SOURCES if not library_path(n).exists())
    t0 = time.perf_counter()
    build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(SOURCES), "compiled": compiled,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_k1():
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    scene = random_scene(np.random.default_rng(0), SCENE_N, sh_degree=1)
    cams = orbit_cameras(VIEWS, HW, HW)
    e = prepare_entries(scene, cams, RasterizeConfig())
    tiles_x, tiles_img = HW // 16, (HW // 16) ** 2
    args = (e.packed_t, e.tile_start, tiles_x, tiles_img)

    out_k, walked_k = composite_fwd(*args)
    torch.cuda.synchronize()
    out_p, walked_p = composite_fwd_plain(*args)
    err_rgb = float((out_k[..., :3] - out_p[..., :3]).abs().max())
    err_t = float((out_k[..., 3] - out_p[..., 3]).abs().max())
    walked_diff = int((walked_k != walked_p).sum())
    ms = cuda_ms(lambda: composite_fwd(*args), 20)
    plain_ms = cuda_ms(lambda: composite_fwd_plain(*args), 2)

    num_entries = int(e.bins.num_entries)
    length = (e.tile_start[1:] - e.tile_start[:-1]).to(torch.int64)[:, None]
    terminated = walked_k.to(torch.int64) < length
    pairs = int(walked_k.to(torch.int64).sum() + terminated.sum())
    ops = K1_OPS_PER_PAIR * pairs
    num_tiles = e.tile_start.shape[0] - 1
    nbytes = (9 * 4 * num_entries + 4 * (num_tiles + 1)
              + num_tiles * 256 * (4 * 4 + 4))
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    result = {
        "phase": "k1", "num_entries": num_entries,
        "num_dropped": int(e.bins.num_dropped), "num_tiles": num_tiles,
        "max_abs_err_rgb": err_rgb, "max_abs_err_T": err_t,
        "walked_mismatches": walked_diff, "pairs_evaluated": pairs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops": ops, "bytes": nbytes}
    emit(result)
    if not (err_rgb <= K1_TOL and err_t <= K1_TOL and walked_diff == 0):
        raise AssertionError(f"K1 disagrees with its plain version: {result}")
    if not (num_entries > 0 and float(out_k[..., 3].min()) < 0.5):
        raise AssertionError("K1 composited nothing")
    return result


def tiny_config():
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    cfg = get_config()
    b = cfg.backbone
    b.enc_depths, b.enc_channels, b.enc_num_head = (1, 1, 1), (16, 16, 32), (2, 2, 4)
    b.dec_depths, b.dec_channels, b.dec_num_head = (1, 1), (16, 16), (2, 2)
    b.stride, b.pool_capacity_factors, b.patch_size = (1, 2), (1.0, 0.75), 64
    cfg.grid_resolution, cfg.zeroinit = 128, False
    return cfg


def make_request(seed, n, n_valid, views, hw, device):
    """A clean scene's render as ground truth, and a perturbed copy of the
    scene as the request."""
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.training.train_step import SceneBatch
    rng = np.random.default_rng(seed)
    clean = random_scene(rng, n, sh_degree=1, n_valid=n_valid, device=device)
    cams = orbit_cameras(views, hw, hw, device=device)
    bg = torch.zeros(3, device=device)
    with torch.inference_mode():
        gt, _ = render_images(clean, cams, bg)
    noise_m = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    noise_s = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    noisy = clean.replace(means=clean.means + 0.004 * noise_m.to(device),
                          scales=clean.scales + 0.1 * noise_s.to(device))
    return SceneBatch(scene=noisy, cameras=cams, images=gt, background=bg)


def phase_reference():
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.train_step import make_eval_step
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_feature_predictor(tiny_config(), device=dev, seed=1,
                                        head_final_scale=0.1)
        batch = make_request(7, 4096, 4000, 2, 64, dev)
        outs[dev] = [x.cpu() for x in make_eval_step(model)(batch)]
    rgb_c, _, psnr_c, ssim_c, drop_c = outs["cpu"]
    rgb_g, _, psnr_g, ssim_g, drop_g = outs["cuda"]
    result = {"phase": "reference", "gaussians": 4096, "views": 2, "hw": 64,
              "max_abs_err_rgb": float((rgb_g - rgb_c).abs().max()),
              "psnr_cpu": psnr_c.tolist(), "psnr_cuda": psnr_g.tolist(),
              "ssim_cpu": ssim_c.tolist(), "ssim_cuda": ssim_g.tolist(),
              "num_dropped": int(drop_g)}
    emit(result)
    if not (result["max_abs_err_rgb"] <= 1e-3
            and float((psnr_g - psnr_c).abs().max()) <= 1e-3
            and float((ssim_g - ssim_c).abs().max()) <= 1e-4
            and int(drop_g) == int(drop_c)):
        raise AssertionError(f"card and CPU eval steps disagree: {result}")


def phase_serving():
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.train_step import make_eval_step

    cfg = get_config()
    cfg.zeroinit = False
    model = build_feature_predictor(cfg, device="cuda", seed=0,
                                    head_final_scale=0.01)
    n_params = sum(p.numel() for p in model.parameters())
    requests = [make_request(100 + i, SCENE_PAD, SCENE_N, VIEWS, HW, "cuda")
                for i in range(REQUESTS)]
    step = make_eval_step(model)
    score_input = make_eval_step(None, render_input=True)
    input_psnr = [float(score_input(r)[2].mean()) for r in requests]
    step(requests[0])  # warm-up
    torch.cuda.synchronize()

    results = []
    reset_launches()
    for i, req in enumerate(requests):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rgb, alpha, psnr, ssim, dropped = step(req)
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        results.append({
            "phase": "serving", "request": i, "latency_ms": latency,
            "psnr": psnr.tolist(), "ssim": ssim.tolist(),
            "input_psnr_mean": input_psnr[i],
            "num_dropped": int(dropped),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "rgb_shape": list(rgb.shape),
            "finite": bool(torch.isfinite(rgb).all()
                           and torch.isfinite(alpha).all())})
    launches = dict(LAUNCHES)
    for r in results:
        emit(r)
    emit({"phase": "serving_summary", "model": "ptv3_base",
          "params": n_params, "requests": REQUESTS, "launches": launches,
          "latency_ms_mean": sum(r["latency_ms"] for r in results) / REQUESTS})
    for r in results:
        if not (r["finite"] and r["rgb_shape"] == [VIEWS, HW, HW, 3]
                and all(np.isfinite(r["psnr"])) and all(np.isfinite(r["ssim"]))):
            raise AssertionError(f"bad eval output: {r}")
    for name, count in launches.items():
        if count != REQUESTS:
            raise AssertionError(
                f"kernel {name} launched {count} times in {REQUESTS} requests")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import splatformer_tpu_torch  # noqa: F401  (the port, from this checkout)

    phase_build()
    k1 = phase_k1()
    phase_reference()
    launches = phase_serving()
    emit({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "splatformer_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "splatformer_tpu/ops/pallas/raster.py:272",
        "launches": launches["composite_fwd"],
        "max_abs_err": max(k1["max_abs_err_rgb"], k1["max_abs_err_T"]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]})
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
