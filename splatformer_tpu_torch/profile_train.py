"""Where the time of one train step goes on the card.

    python -m splatformer_tpu_torch.profile_train [--flash] [--f32]
    # needs a GPU

Builds chip_smoke.py's training configuration (PTv3-base at full width,
bf16 blocks, drop_path 0.3, zero-init heads, the recipe's Adam; one scene
of 100k Gaussians padded to 100352 x 4 views at 256^2, L1 loss;
``--flash``: enable_flash, patch 1024 through K3; ``--f32``: float32
blocks, train.bf16 off, so K3 runs in float32), then prints JSON lines:
  stages    median ms (CUDA events, 3 runs after a warm-up) of the refine
            forward (train mode, autograd on), the render forward, the
            render backward (K2 and the autograd of projection, SH and the
            entry gather; the render's inputs detached from the model),
            the optimizer step, and the whole train step; the backbone's
            and heads' share is the step less the other stages;
  profile   torch.profiler over one train step: the summed device time of
            all kernels, the wall time, the device's busy share, the
            device time of K1, K2, K3-fwd and K3-bwd (its dQ and dK/dV
            passes), and the ten kernels with the most device time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from splatformer_tpu_torch.profile_eval import _device_time_us, _ms, kernel_ms

ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")


def main(flash: bool = False, f32: bool = False) -> None:
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops.render import (render_images,
                                                  render_images_stats)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import (SceneBatch,
                                                           make_train_step)

    tcfg = train_config()
    tcfg.bf16 = not f32
    cfg = get_config()
    cfg.backbone.enable_flash = flash
    model = build_feature_predictor(
        cfg, device="cuda", seed=0,
        compute_dtype="bfloat16" if tcfg.bf16 else None)
    oc = tcfg.optimizer
    opt = build_optimizer(model, dict(oc.lr_dict), oc.type, oc.eps,
                          oc.schedule, tcfg.total_steps, oc.warmup_steps,
                          tcfg.grad_clip_norm)
    rng = np.random.default_rng(100)
    clean = random_scene(rng, 100_352, sh_degree=1, n_valid=100_000)
    cams = orbit_cameras(4, 256, 256)
    bg = torch.zeros(3, device="cuda")
    with torch.inference_mode():
        gt, _ = render_images(clean, cams, bg)
    noise = torch.as_tensor(rng.normal(size=(100_352, 3)),
                            dtype=torch.float32, device="cuda")
    scene = clean.replace(means=clean.means + 0.004 * noise)
    batch = SceneBatch(scene=scene, cameras=cams, images=gt, background=bg)
    gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
    step = make_train_step(model, opt)
    model.train()

    def refine():
        return model(scene, gen)

    with torch.no_grad():
        refined = refine()
    leaves = {k: getattr(refined, k).detach().requires_grad_()
              for k in ATTRS}
    leaf_scene = refined.replace(**leaves)

    def render():
        return render_images_stats(leaf_scene, cams, bg)[0]

    def render_fwd_bwd():
        torch.mean(torch.abs(render() - gt)).backward()

    def optimizer_step():
        for p in opt.params:
            p.grad = torch.zeros_like(p)
        opt.step()

    stages = {
        "refine_fwd_ms": _ms(refine, 3),
        "render_fwd_ms": _ms(render, 3),
        "render_fwd_bwd_ms": _ms(render_fwd_bwd, 3),
        "optimizer_ms": _ms(optimizer_step, 3),
        "train_step_ms": _ms(lambda: step(batch, gen), 3),
    }
    stages["render_bwd_ms"] = (stages["render_fwd_bwd_ms"]
                               - stages["render_fwd_ms"])
    stages["backbone_and_heads_fwd_bwd_ms"] = (
        stages["train_step_ms"] - stages["render_fwd_bwd_ms"]
        - stages["optimizer_ms"])
    print(json.dumps({"phase": "stages", "flash": flash,
                      "compute_dtype": "bfloat16" if tcfg.bf16 else "float32",
                      **stages}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_time_us(e) > 0]
    kernels.sort(key=_device_time_us, reverse=True)
    device_ms = sum(_device_time_us(e) for e in kernels) / 1e3

    print(json.dumps({
        "phase": "profile", "wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": (device_ms / wall_ms if kernels
                              else "not measured"),
        "k1_ms": kernel_ms(kernels, "composite_fwd_kernel"),
        "k2_ms": kernel_ms(kernels, "composite_bwd_kernel"),
        "k3_fwd_ms": kernel_ms(kernels, "attention_fwd_"),
        "k3_bwd_ms": kernel_ms(kernels, "attention_bwd_"),
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:90], "ms": _device_time_us(e) / 1e3,
                         "calls": e.count} for e in kernels[:10]]}),
        flush=True)
    print(json.dumps({"phase": "memory", "peak_gb":
                      torch.cuda.max_memory_allocated() / 2 ** 30}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Where the time of one train step goes.")
    parser.add_argument("--flash", action="store_true",
                        help="PTv3-base with enable_flash (patch 1024, K3)")
    parser.add_argument("--f32", action="store_true",
                        help="float32 blocks (train.bf16 off)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA GPU")
    main(args.flash, args.f32)
