#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one JSON line:
  build     compile every CUDA kernel from csrc/ (one nvcc per source, all
            started together, sm_90a) and, beside them, the JPEG decoder
            (csrc/jpeg_decode.cpp, the host C++ compiler), then read the K3
            libraries with
            cuobjdump: each kernel's registers a thread and its counts of
            HMMA (tensor-core), MUFU.EX2, LDSM and LDS.128 instructions,
            its stack and local (spill) bytes; fails if a bfloat16 K3
            kernel has no HMMA or a float32 one (forward, dQ and dK/dV
            passes) no HMMA.1688.F32.TF32, so the tensor cores are on the
            path;
  k1        the compositing forward K1 against its plain PyTorch version on
            the entries that the port's own binning makes for a
            100k-Gaussian scene under 4 orbit views at 256^2 (limit 1e-5,
            walked counts exact), with its time, the plain version's, its
            bound (bytes, and the live pairs' operations) and the same
            operations at the unfused FP32 rate
            (unfused_fp32_ms); the warp-box cull's plain predicate
            (warp_box_keep_plain) on the same entries: the kept share of
            the warp-iterations and the live pairs it culls, which must be 0;
  k2        the compositing backward K2 against its plain version on the
            same entries with a seeded random cotangent (T channel
            included): each gradient row within 1e-4 of its own largest
            magnitude, exact zeros outside the replayed ranges; times,
            bound, unfused_fp32_ms and the cull's numbers over the replay;
  projection  the fused projection P1 (kernels/projection.py) at the
            serving cells' shapes (100,352 slots, 4 views at 256^2 and 16
            at 512^2, SH degree 1): its forward against its plain version
            on the card, every output bit for bit (a failure counts and
            names the differing (view, slot) pairs by field), its backward
            against the plain version's autograd with a seeded dense
            cotangent (each gradient within 1e-5 of its largest magnitude)
            and bit-identical across two runs; each kernel's device time
            (a CUDA-only torch.profiler trace), the forward call's pace on
            the host, the plain version's forward and backward, and the
            byte bound of each (each input byte read once, each output
            byte written once); one launch each;
  fps       the FPS kernel F1 (kernels/fps.py): the association of
            PyTorch's CUDA sum of 3 (16M random rows against the three:
            csrc/fps.cu's must match every row); its picks against the
            plain loop's on the card bit for bit at 100,352 slots and ratio
            0.35 (100k and 50k live points, two scenes each, and a coarse
            grid with duplicates); fps_knn_downsample launching it once and
            never the plain loop; its time (CUDA events), the plain loop's,
            its bound (10 n m FP32 operations) and each template's
            registers and spills (cuobjdump);
  k3        the patch-attention forward K3-fwd against its plain version
            at each (B, H, d) class of PTv3-base's flash path (patch 1024),
            float32 (split-TF32 tensor-core kernel) and bfloat16
            (tensor-core kernel), seeded q, k, v: o within K3_FWD_TOL of its
            largest magnitude, lse within K3_LSE_TOL; its time, registers a
            thread, the plain version's time, its bound
            (float32 beside the FP32 pipes' time, fp32_pipe_ms) and, as a
            yardstick only, the time of F.scaled_dot_product_attention on
            the same tensors;
  k3_bwd    the same for the backward K3-bwd (dQ pass, then dK/dV pass)
            with a seeded cotangent: each gradient within K3_BWD_TOL of its
            largest magnitude; the yardstick is SDPA's forward + backward
            less its forward;
  reference a tiny FeaturePredictor eval step on the card against the same
            step on the CPU (plain versions), same seed and weights;
  reference_flash  the same with a tiny enable_flash model (patch 128,
            head widths 16, 24 and 32): K3-fwd once a block;
  merge_reference  tiny models of every other model config (the ten
            ptv3_* variants, spunet), the three ToMeSD modes on ptv3_tome,
            PT_embedding and turn_off_bn, card against CPU: the first
            block's merge selection and every downsampler's indices
            identical, refined attributes within 1e-4, PSNR 1e-3 dB, SSIM
            1e-4, K1 once, K3 never; the share of identical selections over
            all merges (near-ties may flip between the two devices' sums);
  serving   PTv3-base at full width, seeded random weights (final head
            layers scaled small), answering 3 eval requests of 100k
            Gaussians (padded to 100352) x 4 views at 256^2 each: latency
            after one warm-up, PSNR/SSIM against a render of the clean scene,
            num_dropped, peak memory; K1 launched once per request, K2
            never;
  serving_flash  the same with enable_flash (patch 1024): K1 once and
            K3-fwd 22 times (once a block, float32) per request, no K2, no
            K3-bwd;
  serving_merge  PTv3-base at full width with each of the ten ptv3_*
            variants and spunet: one warm-up, then 2 requests of 100k
            Gaussians x 4 views at 256^2: latency, peak memory, PSNR against
            the clean render, finite outputs, num_dropped 0, K1 once a
            request and K3 never; every merge leaves the tokens a patch that
            the JAX package's counts give (expected_tokens; ALGM keeps K'
            = K and reports its live tokens), each downsampling its live
            points; for fps FPS's ms alone (the F1 kernel) and one F1
            launch a request;
  serving_merge_flash  ptv3_tome with enable_flash and tome_attention off:
            the attention stays on K3 (22 launches a request), tome_mlp
            merges the MLP's tokens;
  training_merge  one bf16 PTv3-base step with ptv3_tome and one with
            ptv3_drop at full width (heads x0.01, so gradients cross the
            merges and the map-back), after a warm-up each: finite losses,
            K1 and K2 once a step; with serving_merge*, the kernels line's
            ``merge_launches``;
  diagnostics  PTv3-base at full width (heads x0.01) on a 100k-Gaussian
            request: two plain forwards and one with diagnostics and
            attention capture on, all three refined scenes bit-identical;
            enc0_n_valid the live count, every stage count within its
            capacity; the per-head replay (utils/attn_replay.py) of
            enc0_block0, the deepest encoder block and dec0_block1 against
            the recorded attention within 1e-4 of its largest magnitude;
            the replay's ms a block, the captured MB; K3 never;
  diagnostics_flash  the same with enable_flash (patch 1024): the recorded
            attention is K3-fwd's float32 output, 22 launches;
  flops     the port's calflops in this process: ptv3_base and the seven
            merging configs at r 0.5 (2 scenes of 16,384 Gaussians) and the
            65,536-Gaussian base_65k anchor, each row equal to gflops.csv's
            by (algo, r) within 1e-9 relative; MLP GFLOPs,
            torch_flop_counter_gflops, ms a forward, the effective-token
            ratio of the merging ones; then an enable_flash base run (its
            analytic count at patch 1024, K3-fwd 22 launches a forward);
  viewer    training/loop.py:evaluation(save_viewer=True) on two 100k
            scenes with PTv3-base: each scene's iteration_0 and iteration_1
            PLYs equal the input's and the refined forward's live
            parameters exactly, viewer.html holds N x 3 points a cloud, K1
            once a scene (the refined render); then ``python -m splatformer_tpu_torch.visualize``
            at its defaults in its own process (20 clouds, index.html,
            viewer.html); with diagnostics*, flops, the kernels line's
            ``diag_launches``;
  train_reference  a tiny model (drop_path 0, a fixed order shuffle,
            LPIPS from seeded random weights) on the card against the CPU:
            2 f32 SGD steps, each from the same state (losses, every
            parameter update, the BatchNorm running statistics); the
            recipe's Adam for 2 steps fed the same gradients (every
            update); one bf16 step (loss, update, size of the bf16
            perturbation);
  train_reference_flash  one f32 SGD step of the tiny enable_flash model
            from one state, card against CPU (loss, every update, the
            running statistics): K3's backward in float32;
  train_repro  two bf16 PTv3-base steps at patch 128 (heads not
            zero-initialised, so the backbone gets gradients) from one
            seeded state, one generator seed and one batch, with the
            recipe's Adam: the largest loss, gradient and parameter
            differences between the two; fails beyond the bf16 perturbation
            train_reference bounds (loss within 1e-3 relative, gradients at
            cosine >= 0.998);
  training  PTv3-base at full width in train mode (bf16 blocks, drop_path
            0.3, zero-init heads), the recipe's Adam (lr 3e-5, eps 1e-15,
            clip 2.0), L1 loss: one warm-up step, then 3 timed steps of
            100k-Gaussian scenes x 4 views at 256^2; finite losses,
            num_dropped 0, the heads updated, peak memory under 60 GB, K1
            and K2 launched once per step;
  training_flash  the same with enable_flash (patch 1024): K1 and K2 once,
            K3-fwd and K3-bwd 22 times each per step; the kernels line's
            ``launches``;
  training_flash_f32  the same in float32 (train.bf16 off, as
            training/loop.py builds the model then): K3-fwd and K3-bwd 22
            times each per step in float32 (the split-TF32 kernels); the
            ``launches`` of the kernels line's float32 K3-bwd entry;
  loop      the training entry point, training/loop.py:run_training, on
            the card: PTv3-base at full width, bf16, the synthetic dataset
            at 2 scenes of 100k Gaussians (padded to 100352) x 4 views at
            256^2, calibrated raster budgets, LPIPS weight 1.0 on
            write_synthetic_weights' file; 20 steps with an eval and a save
            at step 10, then a second call that resumes from the step-20
            checkpoint to step 25 (an eval at 20): finite losses,
            num_dropped 0 on every step, the eval.csv rows, the resume at
            the stored step, K1 and K2 launched exactly as often as the
            calls render (steps, eval renders of the refined and the input
            scenes, ground truth, train images) and K2 once a step; the
            kernels line's ``loop_launches``;
  dp_training  in an NCCL process group of world size 1 (a file store in
            a temporary directory): the data-parallel train step (``mesh``,
            BatchNorm synced over its data group) against the plain step,
            PTv3-base at full width with the recipe, from one state, one
            generator seed and one batch, each under
            torch.use_deterministic_algorithms (else the gathers' atomic
            scatter-adds differ run to run, train_repro): loss, every
            gradient, the updated parameters and the BatchNorm statistics
            bit-identical, K1 and K2 once a step both ways; the step's ms
            both ways, the gradient all-reduce's ms over the 47.9M float32
            gradients; reduce_metric_sums and sync_processes at world size
            1;
  dp_training_flash  the same with enable_flash: K3-fwd and K3-bwd 22
            times a step both ways;
  gauss_shard  render_images_gauss_sharded on a 100k-Gaussian scene
            (padded to 100,352) x 4 views at 256^2 through the NCCL group
            (G = 1), LocalShards(2) and LocalShards(4), against the
            unsharded render: rgb and alpha within 2e-5, the gradients of
            mean(rgb^2) within 1e-5 + 5e-3 |g| (tests/test_gauss_shard.py's
            bounds), nothing dropped, K1 and K2 G times each a forward and
            backward; ms at each G and unsharded, the exchange's bytes per
            rank; then K1 and K2 against their plain versions on the row
            blocks of one destination (K1's and K2's limits above);
  train2d   the 2-D (data x gauss) step on PTv3-base (bf16, heads x0.01),
            each from one state under the deterministic mode: (1, 1) over
            NCCL groups against the DP step and (1, LocalShards(2)) against
            (1, 1), loss within 1e-6 relative and gradient cosine >=
            0.99999; K1 and K2 G times a step, step ms, peak memory;
  dryrun    ``torchrun --standalone --nproc_per_node=1 -m
            splatformer_tpu_torch.dryrun_multichip`` in its own processes:
            a DP step, a sharded render's value and gradient, a 2-D step,
            each finite; with dp_training*, gauss_shard and train2d, the
            kernels line's ``parallel_launches``;
  fit_reference  the per-scene fit (training/fit_gs.py) at
            tests/test_fit_gs.py's size (capacity 1,024, 5 views at 48^2,
            60 steps, one densify), card against CPU: one step's loss
            (1e-5 relative) and gradients (K2's 1e-4 of each attribute's
            largest magnitude) from one state, densify's slot order on
            scores with ties and its mask on forged statistics (identical),
            and whole fits at seeds 0-2 by their PSNR (FIT_PSNR_DB), last
            loss (FIT_LAST_LOSS_RTOL) and live count (equal), beside three
            faults planted by a setting, each of which must fail that
            agreement; K1 and K2 launched as counted;
  fit_kernels  K1 and K2 against their plain versions (K1's and K2's limits
            above) at the shapes the factory's fit gives them: one 256^2
            input view, the factory's tiers and max_intersects, of the
            98,304-Gaussian ground truth and of the scene fitted from it at
            the factory's settings (65,536 slots, 300 steps); nothing
            dropped; the kernels' times at those shapes;
  factory   ``python -m splatformer_tpu_torch.make_ood_benchmark`` in its
            own process at the widths of scripts/run_oodbench_scale.sh (256^2,
            98,304 ground-truth Gaussians, 65,536 slots from 49,152 seed
            points, max_intersects 524,288, tiers 8,32768,24,4096) for 2
            train and 1 test scene of 300 fit steps, then again (it must
            skip all three); run_training on its folder (--dataset
            oodbench_scale, PTv3-base, bf16, LPIPS) for 10 steps with an
            eval at 5; ``--only_eval --compare_with_input`` through the CLI
            in its own process: the layout, finite fit losses, each fit's
            input-view PSNR above its OOD views', num_dropped 0, the eval.csv
            rows, K1 and K2 launched as counted (the generator prints its
            own counts: per scene 2 ground-truth renders + the fit steps +
            2 eval_fit renders for K1, the fit steps for K2); the kernels
            line's ``fit_launches``;
  jpeg      the JPEG decoders on the card machine's host: every fixture of
            tests/data/jpeg/manifest.json through the compiled decoder
            (data/jpeg.py:decode_jpeg) and its numpy plain version, each
            image's SHA-256 equal to libjpeg-turbo's in the manifest, the
            refused files raising NotImplementedError by name; ms a
            megapixel of both over the capture's 12 views at 512^2;
            image_io.decode_batch of the views against serial
            decode_image; the host CPU's model (/proc/cpuinfo and its
            CPUID brand string); then ``python -m
            splatformer_tpu_torch.fit_3dgs`` on that JPEG capture in its
            own process (JPEG_FIT_STEPS steps): finite losses, the last
            logged below the first, its train-view PSNR, an npz of .jpg
            views, K1 launched once a step and once for its final render,
            K2 once a step, by its own count; the kernels line's
            ``capture_launches``;
  bench     ``python -m splatformer_tpu_torch.bench`` in its own process
            (100k Gaussians, 4 views at 256^2: rasterizer forward +
            backward, then a PTv3-base bf16 train step): its final JSON
            line parses, with bench.py's keys, positive rates and the
            card's name and power limit.
Launch counts are reset at the start of each phase and checked per phase.
Then the smoke's total seconds (and the merge, diag and parallel phases'
shares), the {"kernels": [...]} line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device it exits 1 before any phase.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SCENE_N = 100_000
SCENE_PAD = 100_352
VIEWS, HW = 4, 256
REQUESTS = 3
TRAIN_STEPS = 3
K1_TOL = 1e-5
# K2 vs its plain version, per gradient row relative to the row's largest
# magnitude (tests/test_torch_kernels.py K2_TOL): the per-pixel values
# round identically, only the order of the 256-pixel sums differs
K2_TOL = 1e-4
# published H100 SXM peaks (dense): FP32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# The K1 and K2 bounds count only the work any correct kernel must do on
# this run's data: their bytes, and the operations of the live (pixel,
# entry) pairs (alpha >= threshold, live_pairs); a dead pair needs no
# arithmetic once it is known to be dead, as the warp-box cull shows.
# FP32 operations of a live pair in K1, expf counted as one: dx, dy, 3
# products and a sum per quadratic term group (9), the 0.5 scale, the clamp,
# the negation, expf, the opacity product, the alpha clamp, the threshold
# compare
K1_OPS_PER_PAIR = 18
# FP32 operations of a live pair in K2: K1's 18 to recompute sigma and
# alpha, g_rgb . c (5), vis (1), the S update (2), d-alpha (5: product, sum,
# 1 - a, quotient, difference), the T update (1), the max-alpha compare (1),
# d-rgb (3) and its 3 adds into the entry's sums over pixels (39 in all); a
# live pair below the max-alpha clamp adds d-sigma (2), dx 4, dy 4, dconic
# 3 + 2 + 3, dopacity 1 and their 6 adds into the sums (25)
K2_OPS_PER_LIVE = 39
K2_OPS_PER_UNCLAMPED = 25
PEAK_MEM_GB = 60.0   # PERF.md section 2: a train step fits without remat
# FP32 operations a clock per SM when no product fuses (K1 and K2 build with
# -fmad=false: 128 lanes issue one operation each, half the 67 TFLOP/s
# peak's two per FMA), x 132 SMs x 1.98 GHz: the unfused_fp32_ms yardstick
# (the bound's operations at that rate)
PEAK_F32_UNFUSED = 128 * 132 * 1.98e9

# K3 on PTv3-base's flash path (patch 1024): shape class -> (B patches, H
# heads, d, blocks a forward), from the padded 100352 points and the pooled
# capacities of models/ptv3.py (pool factors 1, 0.75, 0.625, 0.5)
K3_PATCH = 1024
K3_CLASSES = {"enc0": (98, 2, 32, 2), "enc1_dec1_dec0": (98, 4, 24, 6),
              "enc2_dec2": (74, 8, 16, 4), "enc3_dec3": (47, 16, 16, 8),
              "enc4": (24, 32, 16, 2)}
K3_BLOCKS = sum(c[3] for c in K3_CLASSES.values())   # 22 attention calls
# K3 against its plain version, relative to the largest magnitude: float32
# sums in another order (~1e-6, CPU emulation of the kernels' order);
# bfloat16 also rounds P, dS and the outputs to bfloat16 in both, where a
# float32 difference can flip a rounding (one bf16 ulp is 3.9e-3 relative)
K3_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
K3_LSE_TOL = 2e-5    # absolute: lse is float32 from float32 logits
K3_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 and TF32 dense tensor-core peaks (NVIDIA H100 SXM data sheet);
# exponentials on the SFU: 16 a clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz, the clock of the 67 TFLOP/s FP32 peak
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# TF32 products a float32-accurate product on the tensor cores (split TF32:
# a_lo b_hi + a_hi b_lo + a_hi b_hi; one TF32 product misses the float32
# limits, tests/test_torch_attention_tf32.py)
TF32_SPLIT = 3
PEAK_EXP = 16 * 132 * 1.98e9


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_ms(fn, name, reps=10):
    """Mean device ms of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, by a CUDA-only torch.profiler trace after one
    warm-up call: the kernel's own time, whatever the host's pace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    if not hits or sum(e.count for e in hits) != reps:
        raise AssertionError(f"the trace holds {hits} for {name}, want "
                             f"{reps} launches")
    us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
             for e in hits)
    return us / reps / 1e3


def with_projection(launches, renders=None, backwards=None, fps=0):
    """``launches`` with the fused projection's (P1) counts: one forward a
    K1 launch and one backward a K2 launch, as every render through
    ops/render.py makes them, unless ``renders`` and ``backwards`` say
    otherwise (the Gaussian-sharded render projects in plain PyTorch); and
    ``fps`` FPS kernel (F1) launches, one a forward of an FPS
    configuration."""
    return {**launches,
            "projection_fwd": (launches["composite_fwd"] if renders is None
                               else renders),
            "projection_bwd": (launches["composite_bwd"] if backwards is None
                               else backwards),
            "fps": fps}


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


# a K3 kernel's mangled name: pass, type (float32's forward is the
# split-TF32 kernel), head width
K3_KERNEL = re.compile(
    r"attention_(fwd|bwd_dq|bwd_dkv)_(f32|tf32x3|bf16)_kernelILi(\d+)E")


def k3_key(m):
    """(pass, "f32" or "bf16", d) of a K3_KERNEL match."""
    t = "f32" if m.group(2) == "tf32x3" else m.group(2)
    return m.group(1), t, int(m.group(3))


# SASS opcodes counted per K3 kernel: tensor-core products (and those of
# them on TF32 operands), SFU exponentials, shared-memory fragment loads
# (ldmatrix, and 16-byte loads)
SASS_COUNTED = {"hmma": "HMMA", "hmma_tf32": "HMMA.1688.F32.TF32",
                "mufu_ex2": "MUFU.EX2", "ldsm": "LDSM", "lds128": "LDS.128"}


def k3_resources(paths):
    """{(pass, type, d): {"hmma": n, "mufu_ex2": n, "ldsm": n,
    "instructions": n, "registers": r, "stack_bytes": b, "local_bytes":
    b}} of every K3 kernel in the built attention libraries, from
    cuobjdump: counts of SASS instructions (all, and of SASS_COUNTED,
    static: a loop body counts once per copy the compiler made), its
    registers a thread and its stack and local (spill) bytes a thread."""
    from splatformer_tpu_torch.kernels.build import nvcc_path
    tool = str(nvcc_path().resolve().with_name("cuobjdump"))
    found = {}
    for name in ("attention_fwd", "attention_bwd"):
        path = str(paths[name])
        sass, usage = (subprocess.run(
            [tool, flag, path], check=True, capture_output=True, text=True,
            timeout=300).stdout for flag in ("-sass", "-res-usage"))
        key = None
        for line in sass.splitlines():
            if "Function" in line:
                m = K3_KERNEL.search(line)
                key = k3_key(m) if m else None
                if key:
                    found[key] = dict.fromkeys(
                        (*SASS_COUNTED, "instructions"), 0)
                    found[key]["kernel"] = m.group(0)
            elif key and re.match(r"\s*/\*[0-9a-f]+\*/\s+\S", line):
                found[key]["instructions"] += 1
                for k, op in SASS_COUNTED.items():
                    found[key][k] += op in line
        key = None
        for line in usage.splitlines():
            m = K3_KERNEL.search(line) if "Function" in line else None
            if m:
                key = k3_key(m)
                continue
            regs = re.search(r"REG:(\d+)", line)
            if key and regs:
                r = found.setdefault(key, {})
                r["registers"] = int(regs.group(1))
                for k, field in (("stack_bytes", "STACK"),
                                 ("local_bytes", "LOCAL")):
                    m = re.search(field + r":(\d+)", line)
                    r[k] = int(m.group(1)) if m else None
                key = None
    return found


def phase_build():
    from splatformer_tpu_torch.kernels.attention import HEAD_DIMS
    from splatformer_tpu_torch.kernels.build import (ALL_SOURCES, build_all,
                                                     library_path)
    compiled = sorted(n for n in ALL_SOURCES if not library_path(n).exists())
    t0 = time.perf_counter()
    paths = build_all()
    seconds = time.perf_counter() - t0
    res = k3_resources(paths)
    emit({"phase": "build", "seconds": seconds,
          "libraries": sorted(ALL_SOURCES), "compiled": compiled,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "k3_kernels": {f"{p} {t} d{d}": r
                         for (p, t, d), r in sorted(res.items())}})
    for p in ("fwd", "bwd_dq", "bwd_dkv"):
        for t in ("f32", "bf16"):
            for d in HEAD_DIMS:
                r = res.get((p, t, d), {})
                if "registers" not in r or "hmma" not in r:
                    raise AssertionError(f"cuobjdump shows no K3 {p} {t} "
                                         f"d{d} kernel: {sorted(res)}")
                if t == "bf16" and r["hmma"] == 0:
                    raise AssertionError(f"bf16 K3 {p} d{d} has no HMMA "
                                         "instruction: no tensor cores")
                if t == "f32" and r["hmma_tf32"] == 0:
                    raise AssertionError(f"f32 K3 {p} d{d} has no "
                                         "HMMA.1688.F32.TF32 instruction: "
                                         "no tensor cores")
    return res


def phase_k1():
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain,
                                                         warp_box_max)
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
    # the live pairs below each pixel's walk, and its terminating entry
    live = live_pairs(*args, walked_k)[0] + int(terminated.sum())
    ops = K1_OPS_PER_PAIR * live
    num_tiles = e.tile_start.shape[0] - 1
    nbytes = (9 * 4 * num_entries + 4 * (num_tiles + 1)
              + num_tiles * 256 * (4 * 4 + 4))
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    # each warp walks its box's entries until its last pixel terminates
    reach = warp_box_max(walked_k.to(torch.int64)
                         + terminated.to(torch.int64))
    cull = cull_stats(*args, reach)
    result = {
        "phase": "k1", "num_entries": num_entries,
        "num_dropped": int(e.bins.num_dropped), "num_tiles": num_tiles,
        "max_abs_err_rgb": err_rgb, "max_abs_err_T": err_t,
        "walked_mismatches": walked_diff, "pairs_evaluated": pairs,
        "pairs_live": live,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "unfused_fp32_ms": ops / PEAK_F32_UNFUSED * 1e3,
        "ops": ops, "bytes": nbytes, **cull}
    emit(result)
    if not (err_rgb <= K1_TOL and err_t <= K1_TOL and walked_diff == 0):
        raise AssertionError(f"K1 disagrees with its plain version: {result}")
    if cull["live_pairs_culled"] != 0:
        raise AssertionError(f"the cull drops live pairs: {result}")
    if not (num_entries > 0 and float(out_k[..., 3].min()) < 0.5):
        raise AssertionError("K1 composited nothing")
    return result


def cull_stats(packed_t, tile_start, tiles_x, tiles_img, reach,
               alpha_threshold=1.0 / 255.0, chunk=64):
    """The warp-box cull of K1 and K2 by its plain predicate
    (warp_box_keep_plain) on these entries: the warp-iterations (each warp
    box's entries below ``reach`` (T, 8)), the share of them kept, the share
    of all (box, entry) pairs kept, and the live pairs (alpha >= threshold
    anywhere in a tile's range, by composite_fwd_plain's operations) that
    the predicate culls."""
    from splatformer_tpu_torch.kernels.composite import (pixel_box,
                                                         warp_box_keep_plain)
    dev = packed_t.device
    keep = warp_box_keep_plain(packed_t, tile_start, tiles_x, tiles_img,
                               alpha_threshold)
    num_tiles, _, max_len = keep.shape
    j = torch.arange(max_len, device=dev)
    kept_iters = int((keep & (j < reach[..., None])).sum())
    iters = int(reach.sum())
    start = tile_start[:-1].long()
    length = (tile_start[1:] - tile_start[:-1]).long()
    local = torch.arange(num_tiles, device=dev) % tiles_img
    p = torch.arange(256, device=dev)
    px = ((local % tiles_x) * 16)[:, None] + (p % 16)[None, :]
    py = (local // tiles_x * 16)[:, None] + (p // 16)[None, :]
    px, py = px.float()[..., None], py.float()[..., None]
    box = pixel_box().to(dev)
    culled_live = 0
    for base in range(0, max_len, chunk):
        jc = base + torch.arange(min(chunk, max_len - base), device=dev)
        in_range = jc[None, :] < length[:, None]
        idx = torch.where(in_range, start[:, None] + jc[None, :], 0)
        e = packed_t[:6, idx]                                   # (6, T, C)
        dx = e[0][:, None, :] - px                              # (T, P, C)
        dy = e[1][:, None, :] - py
        c0, c1, c2 = (e[k][:, None, :] for k in (2, 3, 4))
        sigma = 0.5 * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy
        alpha = torch.clamp(e[5][:, None, :]
                            * torch.exp(-torch.clamp(sigma, min=0.0)),
                            max=0.999)
        on = (alpha >= alpha_threshold) & in_range[:, None, :]
        culled_live += int((on & ~keep[:, :, jc][:, box, :]).sum())
    return {"warp_iterations": iters, "warp_iterations_kept": kept_iters,
            "kept_share": kept_iters / max(iters, 1),
            "box_entries_kept_share": float(keep.sum())
            / max(8 * int(length.sum()), 1),
            "live_pairs_culled": culled_live}


def replayed_columns(tile_start, walked, budget):
    """(budget,) bool: the entry columns some pixel of their tile replays,
    [start, start + longest walk) of each tile."""
    start = tile_start[:-1].long()
    stop = start + walked.long().max(dim=1).values
    edge = torch.zeros(budget + 1, dtype=torch.int64, device=start.device)
    edge.index_add_(0, start, torch.ones_like(start))
    edge.index_add_(0, stop, -torch.ones_like(stop))
    return torch.cumsum(edge, 0)[:-1] > 0


def live_pairs(packed_t, tile_start, tiles_x, tiles_img, walked,
               alpha_threshold=1.0 / 255.0, max_alpha=0.999, chunk=64):
    """(live, unclamped): the replayed (pixel, entry) pairs whose alpha
    reaches the threshold, and those of them below the max-alpha clamp --
    the pairs K2 differentiates, by composite_bwd_plain's ``live`` mask."""
    dev = packed_t.device
    num_tiles = tile_start.shape[0] - 1
    start = tile_start[:-1].long()
    local = torch.arange(num_tiles, device=dev) % tiles_img
    p = torch.arange(256, device=dev)
    px = ((local % tiles_x) * 16)[:, None] + (p % 16)[None, :]
    py = (local // tiles_x * 16)[:, None] + (p // 16)[None, :]
    px, py = px.float()[..., None], py.float()[..., None]
    n_walk = walked.long()[..., None]
    live = unclamped = 0
    for base in range(0, int(n_walk.max()), chunk):
        j = base + torch.arange(chunk, device=dev)
        idx = (start[:, None] + j[None, :]).clamp(max=packed_t.shape[1] - 1)
        e = packed_t[:6, idx]                                   # (6, T, C)
        dx = e[0][:, None, :] - px                              # (T, P, C)
        dy = e[1][:, None, :] - py
        c0, c1, c2 = (e[k][:, None, :] for k in (2, 3, 4))
        sigma = 0.5 * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy
        raw = e[5][:, None, :] * torch.exp(-torch.clamp(sigma, min=0.0))
        on = (torch.clamp(raw, max=max_alpha) >= alpha_threshold) \
            & (j[None, None, :] < n_walk)
        live += int(on.sum())
        unclamped += int((on & (raw < max_alpha)).sum())
    return live, unclamped


# P1's gradients against the plain version's autograd, relative to each
# gradient's largest magnitude: both round each forward operation alike,
# the backward sums the views and the chain's terms in another order
P1_BWD_TOL = 1e-5
P1_CASES = ((VIEWS, HW), (16, 512))   # serve_4x256, serve_16x512
P1_FIELDS = ("depths", "radii", "num_tiles_hit", "radii_xy", "tile_offset")


def phase_projection():
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.kernels.projection import (padded,
                                                          project_views,
                                                          project_views_plain)
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    attrs = ("means", "scales", "quats", "opacities", "features_dc",
             "features_rest")
    scene = random_scene(np.random.default_rng(0), SCENE_PAD, sh_degree=1,
                         n_valid=SCENE_N)
    cfg = RasterizeConfig()
    n_pad = padded(SCENE_PAD)
    # what any projection must move: the scene once, its outputs once
    in_bytes = sum(getattr(scene, k).numel() * 4 for k in attrs) + SCENE_PAD
    rows = []
    for views, hw in P1_CASES:
        cams = orbit_cameras(views, hw, hw)
        reset_launches()
        k = project_views(scene, cams, cfg)
        torch.cuda.synchronize()
        fwd_launches = LAUNCHES["projection_fwd"]
        p = project_views_plain(scene, cams, cfg)
        differ = {"packed_t": (k.packed_t != p.packed_t).any(dim=0)}
        for name in P1_FIELDS:
            a = getattr(k.proj, name, None)
            b = getattr(p.proj, name, None)
            if a is None:
                a, b = getattr(k, name), getattr(p, name)
            differ[name] = (a != b).reshape(a.shape[0], -1).any(dim=1)
        any_col = torch.stack(list(differ.values())).any(dim=0)
        named = [divmod(int(c), n_pad) for c in torch.nonzero(any_col)[:20, 0]]
        fwd_ms = kernel_ms(lambda: project_views(scene, cams, cfg),
                           "projection_fwd_kernel")
        host_ms = cuda_ms(lambda: project_views(scene, cams, cfg), 20)
        plain_ms = cuda_ms(lambda: project_views_plain(scene, cams, cfg), 3)

        gen = torch.Generator(device="cuda").manual_seed(views)
        g_packed = torch.randn((16, views * n_pad), generator=gen,
                               device="cuda")
        g_packed[9:] = 0.0

        def grads(project):
            leaves = {a: getattr(scene, a).detach().clone()
                      .requires_grad_(True) for a in attrs}
            out = project(scene.replace(**leaves), cams, cfg)
            (out.packed_t * g_packed).sum().backward()
            return {a: x.grad for a, x in leaves.items()}
        reset_launches()
        g_k = grads(project_views)
        bwd_launches = LAUNCHES["projection_bwd"]
        g_k2 = grads(project_views)
        g_p = grads(project_views_plain)
        bwd_ms = kernel_ms(lambda: grads(project_views),
                           "projection_bwd_kernel")
        # the plain version's forward and backward, less its forward
        plain_bwd_ms = cuda_ms(lambda: grads(project_views_plain), 3) \
            - plain_ms
        rel_err = {a: float((g_k[a] - g_p[a]).abs().max()
                            / g_p[a].abs().max()) for a in attrs}
        repeat = all(torch.equal(g_k[a], g_k2[a]) for a in attrs)

        out_bytes = views * n_pad * (16 * 4 + 4 + 4 + 4 + 8 + 4)
        cot_bytes = views * n_pad * 9 * 4
        row = {"phase": "projection", "views": views, "hw": hw,
               "slots": SCENE_PAD,
               "differing_pairs": int(any_col.sum()),
               "differing_by_field": {f: int(d.sum())
                                      for f, d in differ.items()},
               "differing_first": named,
               "bwd_max_rel_err": rel_err, "bwd_bit_identical": repeat,
               "fwd_ms": fwd_ms, "fwd_host_ms": host_ms,
               "fwd_bound_ms": (in_bytes + out_bytes) / PEAK_BYTES * 1e3,
               "plain_ms": plain_ms, "bwd_ms": bwd_ms,
               "bwd_bound_ms": (2 * in_bytes - SCENE_PAD + cot_bytes)
               / PEAK_BYTES * 1e3,
               "plain_bwd_ms": plain_bwd_ms,
               "live": int((k.proj.radii > 0).sum()),
               "launches": {"fwd": fwd_launches, "bwd": bwd_launches}}
        emit(row)
        rows.append(row)
        if not (row["differing_pairs"] == 0
                and max(rel_err.values()) <= P1_BWD_TOL and repeat
                and fwd_launches == 1 and bwd_launches == 1
                and row["live"] > views * SCENE_N // 2):
            raise AssertionError(f"P1 disagrees with its plain version: "
                                 f"{row}")
    return rows


FPS_RATIO = 0.35          # ptv3_fps's ratio: 35,123 picks of 100,352 slots
FPS_SEEDS = (0, 1)        # scenes a live count in the fps phase
FPS_ORDERS = ("(a+b)+c", "(a+c)+b", "a+(b+c)")
FPS_ORDER = "(a+c)+b"     # csrc/fps.cu's association of the 3-term sum
FPS_KERNEL = re.compile(r"fps_kernelILi(\d+)E")


def fps_resources(path):
    """{points a thread: {"registers", "stack_bytes", "local_bytes"}} of
    the FPS library's kernels, from cuobjdump -res-usage."""
    from splatformer_tpu_torch.kernels.build import nvcc_path
    tool = str(nvcc_path().resolve().with_name("cuobjdump"))
    usage = subprocess.run([tool, "-res-usage", str(path)], check=True,
                           capture_output=True, text=True, timeout=300).stdout
    found, key = {}, None
    for line in usage.splitlines():
        m = FPS_KERNEL.search(line) if "Function" in line else None
        if m:
            key = int(m.group(1))
            continue
        regs = re.search(r"REG:(\d+)", line)
        if key is not None and regs:
            found[key] = {"registers": int(regs.group(1)),
                          **{k: int(re.search(f + r":(\d+)", line).group(1))
                             for k, f in (("stack_bytes", "STACK"),
                                          ("local_bytes", "LOCAL"))}}
            key = None
    return found


def phase_fps():
    """F1, the FPS kernel (kernels/fps.py): the association PyTorch's CUDA
    sum of 3 takes (16M random rows of squares spread over 12 decades
    against the three associations: the kernel's must match every row,
    the others not); the kernel's picks against the plain loop's on the
    card, bit for bit, at 100,352 slots and ratio 0.35 with 100k and 50k
    live points (FPS_SEEDS each) and on a coarse grid with duplicates;
    fps_knn_downsample launching it once and never the plain loop; its
    time (CUDA events), the plain loop's, the bound (10 n m FP32
    operations at the FP32 peak, or its bytes) and each kernel's
    registers and spills."""
    from splatformer_tpu_torch.data.synthetic import random_scene
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.kernels.build import library_path
    from splatformer_tpu_torch.ops import downsample

    gen = torch.Generator(device="cuda").manual_seed(0)
    wrong = dict.fromkeys(FPS_ORDERS, 0)
    for _ in range(4):
        x = torch.randn((4_000_000, 3), generator=gen, device="cuda")
        x = x * torch.pow(10.0, torch.rand(x.shape, generator=gen,
                                           device="cuda") * 6 - 3)
        sq = x.square()
        got = sq.sum(dim=1)
        a, b, c = sq.unbind(1)
        for name, v in zip(FPS_ORDERS, ((a + b) + c, (a + c) + b,
                                        a + (b + c))):
            wrong[name] += int((v != got).sum())
    m = int(SCENE_PAD * FPS_RATIO)
    rows = []
    for live in (SCENE_N, SCENE_N // 2):
        for seed in FPS_SEEDS:
            scene = random_scene(np.random.default_rng(700 + seed), SCENE_PAD,
                                 n_valid=live)
            k = downsample.furthest_point_sampling(scene.means, scene.mask, m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = downsample.furthest_point_sampling_plain(scene.means,
                                                         scene.mask, m)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            rows.append({"live": live, "seed": seed,
                         "differing_picks": int((k != p).sum()),
                         "ms": cuda_ms(lambda: downsample
                                       .furthest_point_sampling(
                                           scene.means, scene.mask, m), 5),
                         "plain_ms": plain_ms,
                         "bound_ms": max(10.0 * live * m / PEAK_F32,
                                         (13.0 * live + 8.0 * m)
                                         / PEAK_BYTES) * 1e3})
    rng = np.random.default_rng(9)
    grid = torch.as_tensor(rng.integers(0, 8, (SCENE_PAD, 3)) / 8.0,
                           dtype=torch.float32, device="cuda")
    grid_mask = torch.as_tensor(rng.uniform(size=SCENE_PAD) < 0.9,
                                device="cuda")
    ties = int((downsample.furthest_point_sampling(grid, grid_mask, m)
                != downsample.furthest_point_sampling_plain(grid, grid_mask,
                                                            m)).sum())
    # the main path: one launch, and the plain loop never runs on the card
    plain, calls = downsample.furthest_point_sampling_plain, []
    downsample.furthest_point_sampling_plain = (
        lambda *a: calls.append(a) or plain(*a))
    try:
        reset_launches()
        scene = random_scene(np.random.default_rng(700), SCENE_PAD,
                             n_valid=SCENE_N)
        feat = scene.features_dc
        downsample.fps_knn_downsample(scene.means, feat, scene.mask,
                                      FPS_RATIO)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        downsample.furthest_point_sampling_plain = plain
    res = fps_resources(library_path("fps"))
    row = {"phase": "fps", "slots": SCENE_PAD, "picks": m,
           "sum_order_mismatches": wrong, "runs": rows,
           "grid_differing_picks": ties, "plain_calls": len(calls),
           "launches": launches, "kernels": res,
           "ms": float(np.median([r["ms"] for r in rows
                                  if r["live"] == SCENE_N])),
           "plain_ms": float(np.median([r["plain_ms"] for r in rows
                                        if r["live"] == SCENE_N])),
           "bound_ms": rows[0]["bound_ms"]}
    emit(row)
    if not (wrong[FPS_ORDER] == 0
            and all(v > 0 for o, v in wrong.items() if o != FPS_ORDER)
            and all(r["differing_picks"] == 0 for r in rows) and ties == 0
            and not calls and launches == with_projection(
                dict.fromkeys(("composite_fwd", "composite_bwd",
                               "attention_fwd", "attention_bwd"), 0), fps=1)
            and len(res) == 8):
        raise AssertionError(f"F1 disagrees with its plain version: {row}")
    return row


def phase_k2():
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels.composite import (composite_bwd,
                                                         composite_bwd_plain,
                                                         composite_fwd,
                                                         warp_box_max)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    scene = random_scene(np.random.default_rng(0), SCENE_N, sh_degree=1)
    cams = orbit_cameras(VIEWS, HW, HW)
    e = prepare_entries(scene, cams, RasterizeConfig())
    tiles_x, tiles_img = HW // 16, (HW // 16) ** 2
    out, walked = composite_fwd(e.packed_t, e.tile_start, tiles_x, tiles_img)
    gen = torch.Generator(device="cuda").manual_seed(5)
    g_out = torch.randn(out.shape, generator=gen, device="cuda")
    args = (e.packed_t, e.tile_start, tiles_x, tiles_img, out, walked, g_out)

    d_k = composite_bwd(*args)
    torch.cuda.synchronize()
    d_p = composite_bwd_plain(*args)
    row_err = [float((d_k[r] - d_p[r]).abs().max())
               / max(float(d_p[r].abs().max()), 1e-30) for r in range(9)]
    max_abs_err = float((d_k - d_p).abs().max())
    replayed = replayed_columns(e.tile_start, walked, e.packed_t.shape[1])
    stray = int((d_k[:, ~replayed] != 0).sum() + (d_k[9:] != 0).sum())
    ms = cuda_ms(lambda: composite_bwd(*args), 20)
    plain_ms = cuda_ms(lambda: composite_bwd_plain(*args), 1)

    num_entries = int(e.bins.num_entries)
    num_tiles = e.tile_start.shape[0] - 1
    pairs = int(walked.to(torch.int64).sum())   # K2 replays exactly these
    live, unclamped = live_pairs(e.packed_t, e.tile_start, tiles_x,
                                 tiles_img, walked)
    ops = K2_OPS_PER_LIVE * live + K2_OPS_PER_UNCLAMPED * unclamped
    nbytes = (9 * 4 * num_entries + 4 * (num_tiles + 1)
              + num_tiles * 256 * (4 * 4 + 4 + 4 * 4)
              + 16 * 4 * e.packed_t.shape[1])
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    # each warp replays its box's entries below its longest walk
    cull = cull_stats(e.packed_t, e.tile_start, tiles_x, tiles_img,
                      warp_box_max(walked.to(torch.int64)))
    result = {
        "phase": "k2", "num_entries": num_entries, "num_tiles": num_tiles,
        "max_abs_err": max_abs_err, "row_rel_err": row_err,
        "replayed_columns": int(replayed.sum()), "stray_nonzeros": stray,
        "pairs_replayed": pairs, "pairs_live": live,
        "pairs_unclamped": unclamped, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "unfused_fp32_ms": ops / PEAK_F32_UNFUSED * 1e3,
        "ops": ops, "bytes": nbytes, **cull}
    emit(result)
    if not (max(row_err) <= K2_TOL and stray == 0):
        raise AssertionError(f"K2 disagrees with its plain version: {result}")
    if cull["live_pairs_culled"] != 0:
        raise AssertionError(f"the cull drops live pairs: {result}")
    if not float(d_k[:9].abs().max()) > 0:
        raise AssertionError("K2 produced no gradient")
    return result


def k3_inputs(b, h, d, dtype, seed):
    """Seeded q, k, v and a cotangent of shape (b, h, K3_PATCH, d); q at
    twice unit scale, so logits spread beyond N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, K3_PATCH, d), generator=gen,
                               device="cuda") for _ in range(4))
    return (2.0 * q).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)


def k3_bound(b, h, d, dtype, backward):
    """(ops ms, bytes ms, FLOPs, exponentials, bytes, FP32-pipe ms) of the
    least work: forward 4 K^2 d FLOP per head (q k^T, P V), backward 2.5
    times that (s, dP, dV, dK, dQ), one exponential per (query, key) pair
    either way; each input read once and each output written once (forward
    q, k, v -> o, lse; backward q, k, v, o, do, lse -> dq, dk, dv). FLOPs on
    the tensor cores: bfloat16 at its peak; float32 as the least
    float32-accurate work there, TF32_SPLIT TF32 products a product at the
    TF32 peak. Exponentials at the SFU rate; the larger of the two is the
    operations' time. The FP32-pipe ms (the FLOPs at the 67 TFLOP/s FP32
    peak) is what a float32 kernel outside the tensor cores could reach,
    kept for comparison with such kernels."""
    pairs = b * h * K3_PATCH ** 2
    flops = (10 if backward else 4) * pairs * d
    tokens = b * h * K3_PATCH
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (8 if backward else 4) * tokens * d * esize + 4 * tokens
    tensor_s = (flops / PEAK_BF16 if dtype == torch.bfloat16
                else TF32_SPLIT * flops / PEAK_TF32)
    ops_ms = max(tensor_s, pairs / PEAK_EXP) * 1e3
    return (ops_ms, nbytes / PEAK_BYTES * 1e3, flops, pairs, nbytes,
            flops / PEAK_F32 * 1e3)


def phase_k3(resources, backward=False):
    """K3-fwd (or K3-bwd) against its plain version at every shape class,
    float32 and bfloat16; ``resources`` is phase_build's cuobjdump table.
    Returns, per dtype, the sums over one forward's K3_BLOCKS launches (each
    class times its blocks)."""
    import torch.nn.functional as F
    from splatformer_tpu_torch.kernels.attention import (attention_bwd,
                                                         attention_bwd_plain,
                                                         attention_fwd,
                                                         attention_fwd_plain)
    name = "k3_bwd" if backward else "k3"
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops_ms": 0.0,
               "bytes_ms": 0.0, "fp32_pipe_ms": 0.0, "max_abs_err": 0.0,
               "max_rel_err": 0.0}
        for i, (cls, (b, h, d, blocks)) in enumerate(K3_CLASSES.items()):
            q, k, v, do = k3_inputs(b, h, d, dtype, seed=30 + i)
            scale = d ** -0.5
            if backward:
                o, lse = attention_fwd(q, k, v, scale)
                args = (q, k, v, o, lse, do, scale)
                got = attention_bwd(*args)
                torch.cuda.synchronize()
                want = attention_bwd_plain(*args)
                ms = cuda_ms(lambda: attention_bwd(*args), 10)
                plain_ms = cuda_ms(lambda: attention_bwd_plain(*args), 2)
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    *leaves, scale=scale), 10)
                sdpa_fb_ms = cuda_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(*leaves, scale=scale),
                    leaves, do), 10)
                library_ms = sdpa_fb_ms - sdpa_fwd_ms
                extra = {}
                ok_extra = True
                tol = K3_BWD_TOL[dtype]
            else:
                got = attention_fwd(q, k, v, scale)
                torch.cuda.synchronize()
                want = attention_fwd_plain(q, k, v, scale)
                lse_err = float((got[1] - want[1]).abs().max())
                got, want = got[:1], want[:1]
                ms = cuda_ms(lambda: attention_fwd(q, k, v, scale), 10)
                plain_ms = cuda_ms(lambda: attention_fwd_plain(q, k, v, scale),
                                   2)
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 10)
                extra = {"lse_max_abs_err": lse_err}
                ok_extra = lse_err <= K3_LSE_TOL
                tol = K3_FWD_TOL[dtype]
            abs_err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
            rel_err = max(float((g.float() - w.float()).abs().max())
                          / max(float(w.float().abs().max()), 1e-30)
                          for g, w in zip(got, want))
            ops_ms, bytes_ms, flops, exps, nbytes, fp32_pipe_ms = k3_bound(
                b, h, d, dtype, backward)
            t = "bf16" if dtype == torch.bfloat16 else "f32"

            def res(field):  # phase_build's reading of this class's kernels
                if backward:
                    return {p: resources[(f"bwd_{p}", t, d)][field]
                            for p in ("dq", "dkv")}
                return resources[("fwd", t, d)][field]
            if t == "f32":
                extra["fp32_pipe_ms"] = fp32_pipe_ms
            row = {"phase": name, "class": cls, "dtype": str(dtype)[6:],
                   "B": b, "H": h, "K": K3_PATCH, "d": d,
                   "blocks_per_forward": blocks, "max_abs_err": abs_err,
                   "max_rel_err": rel_err, **extra, "ms": ms,
                   "registers_per_thread": res("registers"),
                   "local_bytes": res("local_bytes"),
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes",
                   "flops": flops, "exps": exps, "bytes": nbytes}
            emit(row)
            if not (rel_err <= tol and ok_extra):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {row}")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("ops_ms", ops_ms),
                             ("bytes_ms", bytes_ms),
                             ("fp32_pipe_ms", fp32_pipe_ms)):
                tot[key] += blocks * val
            tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel_err)
            del q, k, v, do, got, want
        if dtype == torch.bfloat16:
            del tot["fp32_pipe_ms"]
        tot["bound_ms"] = max(tot["ops_ms"], tot["bytes_ms"])
        tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                           else "bytes")
        totals[str(dtype)[6:]] = tot
        torch.cuda.empty_cache()
    emit({"phase": f"{name}_summary",
          "per": f"one forward pass: {K3_BLOCKS} launches at the flash "
                 f"path's shapes", **totals})
    return totals


def tiny_config():
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    cfg = get_config()
    b = cfg.backbone
    b.enc_depths, b.enc_channels, b.enc_num_head = (1, 1, 1), (16, 16, 32), (2, 2, 4)
    b.dec_depths, b.dec_channels, b.dec_num_head = (1, 1), (16, 16), (2, 2)
    b.stride, b.pool_capacity_factors, b.patch_size = (1, 2), (1.0, 0.75), 64
    cfg.grid_resolution, cfg.zeroinit = 128, False
    return cfg


def tiny_flash_config():
    """tiny_config with enable_flash at patch 128 and head widths 16, 24
    and 32 (enc0, enc1 and dec1, enc2), the three of PTv3-base: 5 blocks."""
    cfg = tiny_config()
    b = cfg.backbone
    b.enc_channels, b.enc_num_head = (32, 48, 64), (2, 2, 2)
    b.dec_channels, b.dec_num_head = (32, 48), (2, 2)
    b.patch_size, b.enable_flash = 128, True
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


def phase_reference(flash=False):
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.train_step import make_eval_step
    cfg = tiny_flash_config() if flash else tiny_config()
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_feature_predictor(cfg, device=dev, seed=1,
                                        head_final_scale=0.1)
        batch = make_request(7, 4096, 4000, 2, 64, dev)
        reset_launches()
        outs[dev] = [x.cpu() for x in make_eval_step(model)(batch)]
    launches = dict(LAUNCHES)  # the card's run
    rgb_c, _, psnr_c, ssim_c, drop_c = outs["cpu"]
    rgb_g, _, psnr_g, ssim_g, drop_g = outs["cuda"]
    result = {"phase": "reference_flash" if flash else "reference",
              "gaussians": 4096, "views": 2, "hw": 64,
              "max_abs_err_rgb": float((rgb_g - rgb_c).abs().max()),
              "psnr_cpu": psnr_c.tolist(), "psnr_cuda": psnr_g.tolist(),
              "ssim_cpu": ssim_c.tolist(), "ssim_cuda": ssim_g.tolist(),
              "num_dropped": int(drop_g), "launches": launches}
    emit(result)
    if not (result["max_abs_err_rgb"] <= 1e-3
            and float((psnr_g - psnr_c).abs().max()) <= 1e-3
            and float((ssim_g - ssim_c).abs().max()) <= 1e-4
            and int(drop_g) == int(drop_c)):
        raise AssertionError(f"card and CPU eval steps disagree: {result}")
    expected = with_projection({"composite_fwd": 1, "composite_bwd": 0,
                                "attention_fwd": 5 if flash else 0,
                                "attention_bwd": 0})
    if launches != expected:
        raise AssertionError(f"{result['phase']} launched {launches}, "
                             f"want {expected}")


def phase_serving(flash=False):
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.train_step import make_eval_step

    name = "serving_flash" if flash else "serving"
    cfg = get_config()
    cfg.zeroinit = False
    cfg.backbone.enable_flash = flash
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
    reset_launches()  # the serving path's own count starts here
    for i, req in enumerate(requests):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rgb, alpha, psnr, ssim, dropped = step(req)
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        results.append({
            "phase": name, "request": i, "latency_ms": latency,
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
    emit({"phase": f"{name}_summary", "model": "ptv3_base",
          "patch": 1024 if flash else 128,
          "params": n_params, "requests": REQUESTS, "launches": launches,
          "latency_ms_mean": sum(r["latency_ms"] for r in results) / REQUESTS})
    for r in results:
        if not (r["finite"] and r["rgb_shape"] == [VIEWS, HW, HW, 3]
                and all(np.isfinite(r["psnr"])) and all(np.isfinite(r["ssim"]))):
            raise AssertionError(f"bad eval output: {r}")
    expected = with_projection({
        "composite_fwd": REQUESTS, "composite_bwd": 0,
        "attention_fwd": K3_BLOCKS * REQUESTS if flash else 0,
        "attention_bwd": 0})
    if launches != expected:
        raise AssertionError(f"{name} launched {launches}, want {expected}")
    return launches


# ---------------------------------------------------------------------------
# token merging, input downsampling and the other model options
# ---------------------------------------------------------------------------

# every model config of the JAX package beside ptv3_base
MERGE_CONFIGS = ("ptv3_tome", "ptv3_tofu", "ptv3_pitome", "ptv3_prune",
                 "ptv3_patch", "ptv3_wpatch", "ptv3_algm", "ptv3_fps",
                 "ptv3_voxel", "ptv3_drop", "spunet")
# the ToMeSD modes, which ride ptv3_tome (the sweep's mapping)
TOMESD_MODES = ("random_patch", "progressive", "important_patch")
MERGE_REQUESTS = 2      # timed requests a configuration, after one warm-up
TINY_SP = dict(base_channels=16, channels=(16, 32), dec_channels=(16,),
               depths=(1, 1), dec_depths=(1,), stride=(2,),
               pool_capacity_factors=(0.75,), output_dim=16)


def option_config(name, tiny=False):
    """The model config ``name``: a config file of the port, a ToMeSD mode
    on ptv3_tome, or ptv3_base with "pt_embedding" or "turn_off_bn"; at
    tiny_config's widths when ``tiny``."""
    from splatformer_tpu_torch.configs import load_config
    if name in TOMESD_MODES:
        cfg = load_config("model", "ptv3_tome")
        cfg.additional_info["tome"] = name
    elif name in ("pt_embedding", "turn_off_bn"):
        cfg = load_config("model", "ptv3_base")
    else:
        cfg = load_config("model", name)
    if tiny:
        t = tiny_config()
        cfg.backbone, cfg.grid_resolution = t.backbone, t.grid_resolution
        cfg.zeroinit = t.zeroinit
        cfg.sp_backbone = dict(TINY_SP) if cfg.sp_backbone else {}
    if name == "pt_embedding":
        cfg.backbone.embedding_type = "PT_embedding"
    cfg.backbone.turn_off_bn = name == "turn_off_bn"
    return cfg


def expected_tokens(info, k):
    """K', the tokens a merge leaves of a patch of k, by the JAX package's
    counts (ops/merging.py: _merge_count caps int(k r) at k // 2; PiToMe's
    protected src slots, pruning's k - 1, the block modes' whole blocks of
    g tokens, wpatch's low_r); ALGM keeps K' = k. Computed here, apart
    from the port's code."""
    mode, r = info["tome"], float(info["r"])
    rc = max(0, min(k // 2, int(k * r)))
    if mode == "pitome" and info.get("protected_ratio", 0.0) > 0:
        n_p = int(np.ceil(info["protected_ratio"] * k))
        rc = min(rc, k // 2 - sum(1 for i in range(k - n_p, k) if i % 2 == 0))
    if mode in ("tome", "tofu", "progressive", "pitome"):
        return k - rc
    if mode == "prune":
        return k - min(rc, k - 1)
    if mode == "algm":
        return k
    if mode == "wpatch":
        rc = min(rc, max(0, k - int(info.get("low_r", 16))))
    g = max(2, min(int(info.get("stride", 10)), k))
    while k % g:
        g -= 1
    return k - (min(k // g, rc // (g - 1)) if g > 1 else 0) * (g - 1)


def route_pattern(merge, metric):
    """merge(I)'s nonzero pattern (B, H, K', K) on the CPU: which tokens
    each reduced token takes, the merge's selection."""
    k = metric.shape[-2]
    eye = torch.eye(k, device=metric.device, dtype=metric.dtype)
    return (merge(eye.expand(*metric.shape[:2], k, k)) != 0).cpu()


def pitome_near_tie_heads(metric, info, tol=1e-6):
    """(B, H) bool: the patch-heads where PiToMe's selection hangs on a
    near-tie, from ``metric`` on the CPU: a similarity within ``tol`` of
    the margin (the energy jumps there by about margin / K) or two energies
    within ``tol`` (their order decides the src/dst split). The energy as
    ops/merging.py:_pitome forms it, written out here."""
    kn = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True)
                   + 1e-6)
    sim = kn @ kn.mT
    margin, alpha = info.get("margin", 0.9), info.get("alpha", 1.0)
    f = torch.where(sim >= margin, sim,
                    alpha * (torch.exp(sim - margin) - 1.0))
    energy = f.mean(-1).sort(-1).values
    return (((sim - margin).abs() < tol).flatten(2).any(-1)
            | ((energy[..., 1:] - energy[..., :-1]) < tol).any(-1))


def unexplained_heads(record):
    """The (patch, head) pairs whose selection the CPU, merging the card's
    own metric, makes otherwise than the card did; for PiToMe, less those
    at a near-tie (pitome_near_tie_heads)."""
    from splatformer_tpu_torch.ops import merging
    pattern, metric, mode, info = record
    mine = route_pattern(merging.build_merge(mode, metric, info)[0], metric)
    differ = ~(mine == pattern).flatten(2).all(-1)
    if mode == "pitome":
        differ &= ~pitome_near_tie_heads(metric, info)
    return int(differ.sum())


class SelectionRecorder:
    """While active, records what the model's merges and downsamplers
    select: each merge's patch size, reduced size and live tokens (size >
    0), with ``routes`` also (route_pattern, its metric, mode, info) on
    the CPU; each downsampling's method, its indices on the CPU (fps's and
    voxel's assignments, random's kept points) and its live reduced
    points."""

    def __init__(self, routes=False):
        self.routes = routes

    def __enter__(self):
        from splatformer_tpu_torch.ops import downsample, merging
        self.merges, self.tokens, self.downsamples = [], [], []
        self._saved = []

        def wrap(module, name, record):
            orig = getattr(module, name)

            def wrapped(*a, **kw):
                out = orig(*a, **kw)
                record(a, out)
                return out
            self._saved.append((module, name, orig))
            setattr(module, name, wrapped)

        def merge(a, out):
            metric, size = a[1], out[2]
            k = metric.shape[-2]
            self.tokens.append((k, size.shape[-2], (size > 0).sum(-2)))
            if self.routes:
                self.merges.append((route_pattern(out[0], metric),
                                    metric.cpu(), a[0], a[2]))
        wrap(merging, "build_merge", merge)
        for name in ("fps_knn_downsample", "voxel_downsample",
                     "random_downsample"):
            wrap(downsample, name, lambda a, out, name=name:
                 self.downsamples.append((name, out[3].cpu(),
                                          int(out[2].sum()))))
        return self

    def __exit__(self, *exc):
        for module, name, orig in self._saved:
            setattr(module, name, orig)

    def token_summary(self):
        """[(k, K', mean live tokens a patch)] of the recorded merges."""
        return [(k, kp, float(live.float().mean()))
                for k, kp, live in self.tokens]


def phase_merge_reference():
    """Tiny models of every config beside ptv3_base (the ToMeSD modes,
    PT_embedding and turn_off_bn too) on the card against the CPU, same
    seed, weights and scene; K1 once on the card's eval step, K3 never.

    Each merge the card made is made again on the CPU from the card's own
    metric: the selections must be identical (the merge is the same
    function on both devices), except in a (patch, head) where PiToMe hangs
    on a near-tie: its similarities and energies are the two devices' own
    sums, and a similarity within an ulp of the margin, or two energies an
    ulp apart, may fall either way (pitome_near_tie_heads). Card and
    CPU sums differ in the last ulp, so such a near-tie in the model's own
    metric may also pick another token between the two runs: the share of
    identical selections is reported, and where every selection and every
    downsampler's indices agree the refined attributes must be within
    1e-4, PSNR within 1e-3 dB and SSIM within 1e-4."""
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops import merging
    from splatformer_tpu_torch.training.train_step import make_eval_step
    attrs = ("means", "scales", "quats", "opacities", "features_dc",
             "features_rest")
    batches = {d: make_request(7, 4096, 4000, 2, 64, d)
               for d in ("cpu", "cuda")}
    rows = []
    for name in MERGE_CONFIGS + TOMESD_MODES + ("pt_embedding",
                                                "turn_off_bn"):
        cfg = option_config(name, tiny=True)
        got, rec = {}, {}
        for dev in ("cpu", "cuda"):
            model = build_feature_predictor(cfg, device=dev, seed=1,
                                            head_final_scale=0.1)
            with SelectionRecorder(routes=True) as rec[dev], \
                    torch.inference_mode():
                refined = model(batches[dev].scene)
            reset_launches()
            ev = make_eval_step(model)(batches[dev])
            launches = dict(LAUNCHES)
            got[dev] = ([getattr(refined, a).cpu() for a in attrs],
                        [x.cpu() for x in ev[2:4]])
        (ref_c, met_c), (ref_g, met_g) = got["cpu"], got["cuda"]
        mg, mc = rec["cuda"].merges, rec["cpu"].merges
        unexplained = sum(unexplained_heads(r) for r in mg)
        same_input = unexplained == 0
        rows_same = [float((a[0] == b[0]).all(-1).float().mean())
                     for a, b in zip(mg, mc)]
        agree = (len(mg) == len(mc) and all(r == 1.0 for r in rows_same)
                 and all(torch.equal(a[1], b[1]) for a, b in
                         zip(rec["cuda"].downsamples,
                             rec["cpu"].downsamples)))
        row = {"config": name,
               "max_abs_err": max(float((a - b).abs().max())
                                  for a, b in zip(ref_g, ref_c)),
               "psnr_err": float((met_g[0] - met_c[0]).abs().max()),
               "ssim_err": float((met_g[1] - met_c[1]).abs().max()),
               "merges": len(mg), "same_input_unexplained_heads": unexplained,
               "first_merge_identical": bool(mg) and rows_same[0] == 1.0,
               "identical_selection_share": (float(np.mean(rows_same))
                                             if rows_same else None),
               "downsamples": len(rec["cuda"].downsamples),
               "all_selections_identical": agree, "launches": launches}
        if mg:
            # the first merge's metric on the two devices, and (PiToMe)
            # the similarities that fall on either side of the margin
            (_, a, mode, info), (_, b, _, _) = mg[0], mc[0]
            row["first_metric_max_abs_diff"] = float((a - b).abs().max())
            if mode == "pitome":
                sims = [merging._normalize(x) @ merging._normalize(x).mT
                        for x in (a, b)]
                row["margin_straddles"] = int(
                    ((sims[0] >= info["margin"])
                     != (sims[1] >= info["margin"])).sum())
        rows.append(row)
        emit({"phase": "merge_reference", **row})
        merges_expected = name not in ("ptv3_fps", "ptv3_voxel", "ptv3_drop",
                                       "spunet", "pt_embedding",
                                       "turn_off_bn")
        close = (row["max_abs_err"] <= 1e-4 and row["psnr_err"] <= 1e-3
                 and row["ssim_err"] <= 1e-4)
        if not (same_input and (close or not agree)
                and bool(mg) == merges_expected
                and (row["downsamples"] > 0) == (name in (
                    "ptv3_fps", "ptv3_voxel", "ptv3_drop"))
                and launches == with_projection({
                    "composite_fwd": 1, "composite_bwd": 0,
                    "attention_fwd": 0, "attention_bwd": 0},
                    fps=int(name == "ptv3_fps"))):
            raise AssertionError(f"merge_reference {name}: {row}")
    shares = [r["identical_selection_share"] for r in rows
              if r["identical_selection_share"] is not None]
    emit({"phase": "merge_reference_summary", "configs": len(rows),
          "configs_all_identical": sum(r["all_selections_identical"]
                                       for r in rows),
          "identical_selection_share_min": min(shares),
          "identical_selection_share_mean": float(np.mean(shares))})


def phase_serving_merge(requests, flash=False):
    """PTv3-base at full width with each config of MERGE_CONFIGS (with
    ``flash``: ptv3_tome with enable_flash and tome_attention off), seeded
    random weights (final head layers x0.01): one warm-up request, which
    records the merges' token counts, then MERGE_REQUESTS timed requests of
    100k Gaussians x 4 views at 256^2. Fails unless the outputs are finite,
    num_dropped is 0, every merge leaves expected_tokens (ALGM: K' = K,
    its live tokens reported), K1 runs once a request and K3 never (with
    ``flash``: 22 times a request). Returns the summed launches."""
    from splatformer_tpu_torch.eval_sweep import fps_ms
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.train_step import make_eval_step
    phase = "serving_merge_flash" if flash else "serving_merge"
    totals = dict.fromkeys(LAUNCHES, 0)
    for name in ("ptv3_tome",) if flash else MERGE_CONFIGS:
        cfg = option_config(name)
        cfg.zeroinit = False
        if flash:
            cfg.backbone.enable_flash = True
            cfg.additional_info["tome_attention"] = False
        model = build_feature_predictor(cfg, device="cuda", seed=0,
                                        head_final_scale=0.01)
        step = make_eval_step(model)
        with SelectionRecorder() as rec:
            step(requests[0])  # warm-up
        torch.cuda.synchronize()
        tokens = rec.token_summary()
        lat, res = [], []
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for req in requests[1:1 + MERGE_REQUESTS]:
            t0 = time.perf_counter()
            rgb, alpha, psnr, ssim, dropped = step(req)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            res.append((bool(torch.isfinite(rgb).all()
                             and torch.isfinite(alpha).all()),
                        float(psnr.mean()), float(ssim.mean()),
                        int(dropped)))
        launches = dict(LAUNCHES)
        info = cfg.additional_info
        row = {"phase": phase, "config": name, "latency_ms": lat,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "psnr": [r[1] for r in res], "ssim": [r[2] for r in res],
               "num_dropped": [r[3] for r in res],
               "finite": all(r[0] for r in res), "launches": launches,
               "merges": len(tokens)}
        if tokens:
            row["tokens_per_patch"] = sorted({(k, kp) for k, kp, _ in tokens})
            row["expected_tokens"] = sorted({(k, expected_tokens(info, k))
                                            for k, _, _ in tokens})
            row["live_tokens_mean"] = float(np.mean([t[2] for t in tokens]))
        if rec.downsamples:
            row["downsample"], _, row["reduced_points"] = rec.downsamples[0]
        if name == "ptv3_fps":
            row["fps_ms"] = fps_ms(requests[0].scene,
                                   info["downsample_ratio"])
        emit(row)
        k3 = K3_BLOCKS * MERGE_REQUESTS if flash else 0
        expect_merges = (0 if name in ("ptv3_fps", "ptv3_voxel", "ptv3_drop",
                                       "spunet")
                         else K3_BLOCKS if flash else 2 * K3_BLOCKS)
        if not (row["finite"] and all(d == 0 for d in row["num_dropped"])
                and all(np.isfinite(row["psnr"]))
                and len(tokens) == expect_merges
                and all(kp == expected_tokens(info, k)
                        for k, kp, _ in tokens)
                and (name != "ptv3_algm"
                     or row["live_tokens_mean"] < tokens[0][0])
                and (name not in ("ptv3_fps", "ptv3_voxel", "ptv3_drop")
                     or row.get("reduced_points", 0) > 0)
                and launches == with_projection({
                    "composite_fwd": MERGE_REQUESTS, "composite_bwd": 0,
                    "attention_fwd": k3, "attention_bwd": 0},
                    fps=MERGE_REQUESTS if name == "ptv3_fps" else 0)):
            raise AssertionError(f"{phase} {name}: {row}")
        for k in totals:
            totals[k] += launches[k]
        del model, step
        torch.cuda.empty_cache()
    return totals


def phase_training_merge(requests):
    """One bf16 train step of PTv3-base at full width with ptv3_tome
    (merging in every block's attention and MLP) and one with ptv3_drop
    (random downsampling drawn from the generator), after a warm-up step
    each; heads not zero-initialised (x0.01) so gradients cross the
    merges and the map-back. Fails unless the losses are finite,
    num_dropped is 0 and K1 and K2 run once a step (K3 never). Returns
    the summed launches."""
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import make_train_step
    tcfg = train_config()
    oc = tcfg.optimizer
    totals = dict.fromkeys(LAUNCHES, 0)
    for name in ("ptv3_tome", "ptv3_drop"):
        cfg = option_config(name)
        cfg.zeroinit = False
        model = build_feature_predictor(cfg, device="cuda", seed=0,
                                        head_final_scale=0.01,
                                        compute_dtype="bfloat16")
        opt = build_optimizer(model, dict(oc.lr_dict), oc.type, oc.eps,
                              oc.schedule, tcfg.total_steps, oc.warmup_steps,
                              tcfg.grad_clip_norm)
        step = make_train_step(model, opt)
        gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
        step(requests[0], gen)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(requests[1], gen)
        torch.cuda.synchronize()
        row = {"phase": "training_merge", "config": name,
               "ms": (time.perf_counter() - t0) * 1e3,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": dict(LAUNCHES),
               **{k: float(v) for k, v in m.items()}}
        emit(row)
        if not (all(np.isfinite(row[k]) for k in
                    ("total_loss", "image_l1", "train_psnr"))
                and row["num_dropped"] == 0
                and row["launches"] == with_projection({
                    "composite_fwd": 1, "composite_bwd": 1,
                    "attention_fwd": 0, "attention_bwd": 0})):
            raise AssertionError(f"training_merge {name}: {row}")
        for k in totals:
            totals[k] += row["launches"][k]
        del model, opt, step
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# the backbone's diagnostics and the tools that read them
# ---------------------------------------------------------------------------

DIAG_REPLAY_TOL = 1e-4   # of the block's largest magnitude (the JAX rtol)
FLOPS_DIR = "build/chip_smoke_flops"
FLOPS_RTOL = 1e-9
FLOPS_N = 16_384
FLOPS_ANCHOR_N = 65_536
FLOPS_ALGOS = ("tome", "pitome", "tofu", "prune", "patch", "wpatch", "algm")
VIEWER_DIR = "build/chip_smoke_viewer"
VIEWER_SCENES = 2
VISUALIZE_DIR = "build/chip_smoke_visualize"


def unique_mb(records):
    """MB held by the recorded tensors, each storage counted once (the
    orders' inverses and the coordinates are views shared by blocks)."""
    seen = {}
    for rec in records.values():
        for t in rec.values():
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values()) / 1e6


def phase_diagnostics(flash=False):
    """PTv3-base at full width (heads x0.01) on a 100k-Gaussian request
    (padded to 100352), at patch 128 or with enable_flash (patch 1024):
    a plain forward twice, then one with diagnostics and attention capture
    on. Fails unless the three refined scenes are bit-identical,
    enc0_n_valid is the live count, every stage count is at most its
    capacity, the per-head replay of enc0_block0, the deepest encoder block
    and dec0_block1, concatenated over heads, equals the recorded attn_feat
    within DIAG_REPLAY_TOL of its largest magnitude (on the flash run:
    K3-fwd's float32 output against plain products), and the recorded
    forward launched K3-fwd 22 times (flash) or never, K1 and K2 never.
    Returns that forward's launches."""
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        ALL_FEATURES, build_feature_predictor)
    from splatformer_tpu_torch.models.ptv3 import capture_attention
    from splatformer_tpu_torch.utils.attn_replay import (head_count_for,
                                                         replay_block,
                                                         with_qkv)
    name = "diagnostics_flash" if flash else "diagnostics"
    cfg = get_config()
    cfg.zeroinit = False
    cfg.backbone.enable_flash = flash
    model = build_feature_predictor(cfg, device="cuda", seed=0,
                                    head_final_scale=0.01)
    bk = cfg.backbone.backbone_kwargs()
    scene = make_request(500 + flash, SCENE_PAD, SCENE_N, VIEWS, HW,
                         "cuda").scene
    with torch.inference_mode():
        plain = model(scene)
        again = model(scene)
        torch.cuda.synchronize()
        diag = {}
        reset_launches()
        t0 = time.perf_counter()
        with capture_attention(model) as raw:
            recorded = model(scene, diagnostics=diag)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
    recs = with_qkv(model, raw)
    identical = {k: bool(torch.equal(getattr(plain, k), getattr(again, k))
                         and torch.equal(getattr(plain, k),
                                         getattr(recorded, k)))
                 for k in ALL_FEATURES}
    n_stages = len(bk["enc_depths"])
    counts, capacity = {}, {}
    for s in range(n_stages):
        counts[f"enc{s}"] = int(diag[f"enc{s}_n_valid"])
        capacity[f"enc{s}"] = recs[f"backbone/enc{s}_block0/attn"][
            "attn_in"].shape[0]
    for key, d in diag["intermediates"].items():
        counts[key] = int(d["n_valid"])
        capacity[key] = d["feat"].shape[0]
    deepest = f"enc{n_stages - 1}_block{bk['enc_depths'][-1] - 1}"
    replays = {}
    for block in ("enc0_block0", deepest, "dec0_block1"):
        path = f"backbone/{block}/attn"
        rec = recs[path]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = replay_block(rec, head_count_for(path, bk),
                           bk["enc_patch_size"][0])
        ms = (time.perf_counter() - t0) * 1e3
        got = np.concatenate(rep["attn_feats"], axis=1)
        want = rec["attn_feat"].cpu().numpy()
        replays[block] = {
            "ms": ms, "rows": int(want.shape[0]),
            "heads": len(rep["attn_feats"]),
            "max_abs_err": float(np.abs(got - want).max()),
            "max_abs": float(np.abs(want).max())}
    result = {"phase": name, "patch": bk["enc_patch_size"][0],
              "gaussians": SCENE_N, "pad": SCENE_PAD, "blocks": len(recs),
              "forward_ms_recorded": forward_ms,
              "capture_mb": unique_mb(recs), "stage_counts": counts,
              "stage_capacity": capacity, "identical": identical,
              "replays": replays, "launches": launches}
    emit(result)
    if not all(identical.values()):
        raise AssertionError(f"{name}: recording changed the refined scene")
    if counts["enc0"] != SCENE_N or any(counts[k] > capacity[k]
                                        for k in counts):
        raise AssertionError(f"{name}: stage counts {counts} "
                             f"(capacity {capacity})")
    for block, r in replays.items():
        if not r["max_abs_err"] <= DIAG_REPLAY_TOL * r["max_abs"]:
            raise AssertionError(f"{name}: the replay of {block} disagrees "
                                 f"with the recorded attention: {r}")
    expected = with_projection({"composite_fwd": 0, "composite_bwd": 0,
                                "attention_fwd": K3_BLOCKS if flash else 0,
                                "attention_bwd": 0})
    if launches != expected or len(recs) != K3_BLOCKS:
        raise AssertionError(f"{name} launched {launches}, want {expected} "
                             f"({len(recs)} blocks recorded)")
    return launches


def read_gflops_csv(path):
    """{(algo, r): gflops} of a CSV in gflops.csv's schema."""
    rows = {}
    with open(path) as f:
        next(f)
        for line in f:
            g, algo, r = line.strip().split(",")
            rows[(algo, float(r))] = float(g)
    return rows


def phase_flops():
    """The port's calflops in this process on the card: ptv3_base and each
    of FLOPS_ALGOS at r 0.5 on 2 scenes of 16,384 Gaussians, and the
    65,536-Gaussian base_65k anchor on one; each row against the repo's
    gflops.csv by (algo, r) within FLOPS_RTOL relative; then one
    enable_flash base run on one scene (its forward and the flop counter's
    each launch K3-fwd 22 times). Returns the flash run's launches."""
    import shutil

    from splatformer_tpu_torch import calflops
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    want = read_gflops_csv("gflops.csv")
    shutil.rmtree(FLOPS_DIR, ignore_errors=True)
    csv = os.path.join(FLOPS_DIR, "gflops.csv")

    def run(n, scenes, *extra):
        args = calflops.parse_args(
            ["--num_scenes", str(scenes), "--csv", csv,
             "--override", f"dataset.n_gaussians={n}",
             "--override", f"dataset.pad_to={n}", *extra])
        return calflops.run(args, torch.device("cuda"))

    results = []
    t0 = time.perf_counter()
    results.append(run(FLOPS_N, 2))
    for algo in FLOPS_ALGOS:
        results.append(run(FLOPS_N, 2, "--model", f"ptv3_{algo}",
                           "--merge_rate", "0.5"))
    results.append(run(FLOPS_ANCHOR_N, 1, "--label", "base_65k"))
    seconds = time.perf_counter() - t0
    got = read_gflops_csv(csv)
    rows = []
    for res in results:
        key = (res["algo"], float(res["r"]))
        rel = abs(got[key] - want[key]) / want[key]
        rows.append({"algo": key[0], "r": key[1], "gflops": got[key],
                     "gflops_csv": want[key], "rel_err": rel,
                     "mlp_gflops": res["mlp_gflops"],
                     "torch_flop_counter_gflops":
                         res["torch_flop_counter_gflops"],
                     "forward_ms": res["forward_ms"],
                     "token_ratio": res.get("token_ratio")})
    shutil.rmtree(FLOPS_DIR, ignore_errors=True)
    reset_launches()
    flash = run(FLOPS_N, 1, "--override", "model.backbone.enable_flash=True",
                "--label", "base_flash")
    launches = dict(LAUNCHES)
    emit({"phase": "flops", "seconds": seconds, "rows": rows,
          "flash": {"gflops": flash["gflops"],
                    "torch_flop_counter_gflops":
                        flash["torch_flop_counter_gflops"],
                    "forward_ms": flash["forward_ms"],
                    "k3_launches_per_forward":
                        launches["attention_fwd"] / 2},
          "launches": launches})
    bad = [r for r in rows if not r["rel_err"] <= FLOPS_RTOL]
    if bad or len(rows) != len(FLOPS_ALGOS) + 2:
        raise AssertionError(f"flops rows differ from gflops.csv: {bad}")
    expected = with_projection({"composite_fwd": 0, "composite_bwd": 0,
                                "attention_fwd": 2 * K3_BLOCKS,
                                "attention_bwd": 0})
    if launches != expected:
        raise AssertionError(f"flops (flash) launched {launches}, want "
                             f"{expected}")
    return launches


def ply_fields(scene, mask):
    """The Inria PLY fields of a scene's live Gaussians (zero normals,
    features_rest colour-major, as utils/viewer.py writes them)."""
    g = {k: getattr(scene, k).float().cpu().numpy()[mask]
         for k in ("means", "scales", "quats", "opacities", "features_dc",
                   "features_rest")}
    n = g["means"].shape[0]
    rest = g["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    fields = {ax: g["means"][:, i] for i, ax in enumerate("xyz")}
    fields.update({ax: np.zeros(n, np.float32) for ax in ("nx", "ny", "nz")})
    fields.update({f"f_dc_{i}": g["features_dc"][:, i] for i in range(3)})
    fields.update({f"f_rest_{i}": rest[:, i] for i in range(rest.shape[1])})
    fields["opacity"] = g["opacities"].reshape(n)
    fields.update({f"scale_{i}": g["scales"][:, i] for i in range(3)})
    fields.update({f"rot_{i}": g["quats"][:, i] for i in range(4)})
    return fields


def phase_viewer():
    """training/loop.py:evaluation(save_viewer=True) with PTv3-base (heads
    x0.01) on VIEWER_SCENES requests of 100k Gaussians x 4 views at 256^2:
    each scene's iteration_0 PLY equals the input's live parameters and
    iteration_1 the refined forward's, exactly (read back with read_ply),
    the vertex count is the live count, viewer.html decodes to N x 3
    floats a cloud, cameras.json has the views; K1 launched once a scene
    (the refined render: the viewer export reads no image, so the input is
    not rendered). Then ``python -m
    splatformer_tpu_torch.visualize`` at its defaults in its own process:
    its clouds, index.html and viewer.html. Returns evaluation's
    launches."""
    import base64
    import shutil

    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training.loop import evaluation
    from splatformer_tpu_torch.utils.viewer import read_ply
    cfg = get_config()
    cfg.zeroinit = False
    model = build_feature_predictor(cfg, device="cuda", seed=0,
                                    head_final_scale=0.01)
    scenes = [(f"scene{i}", make_request(600 + i, SCENE_PAD, SCENE_N, VIEWS,
                                         HW, "cuda"))
              for i in range(VIEWER_SCENES)]
    shutil.rmtree(VIEWER_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics, _, _ = evaluation(model, scenes, RasterizeConfig(), VIEWER_DIR,
                               save_viewer=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    checks = []
    for name, batch in scenes:
        vdir = os.path.join(VIEWER_DIR, "viewer", name)
        mask = batch.scene.valid_mask().cpu().numpy()
        with torch.inference_mode():
            refined = model(batch.scene)
        row = {"scene": name}
        for it, src in (("iteration_0", batch.scene), ("iteration_1",
                                                       refined)):
            got = read_ply(os.path.join(vdir, "point_cloud", it,
                                        "point_cloud.ply"))
            want = ply_fields(src, mask)
            row[it] = {"vertices": int(len(got["x"])),
                       "exact": list(got) == list(want) and all(
                           np.array_equal(got[k], want[k]) for k in want)}
        with open(os.path.join(vdir, "viewer.html")) as f:
            data = json.loads(re.search(r"const DATA = (\[.*?\]);", f.read(),
                                        re.S).group(1))
        row["viewer_points"] = [
            len(base64.b64decode(d["pos"])) // 12 for d in data]
        with open(os.path.join(vdir, "cameras.json")) as f:
            row["cameras"] = len(json.load(f))
        row["moved"] = float((refined.means - batch.scene.means).abs().max())
        checks.append(row)
    emit({"phase": "viewer", "seconds": seconds, "scenes": checks,
          "psnr": metrics.get("psnr"), "launches": launches})
    for row in checks:
        if not (row["iteration_0"]["exact"] and row["iteration_1"]["exact"]
                and row["iteration_0"]["vertices"] == SCENE_N
                and row["viewer_points"] == [SCENE_N, SCENE_N]
                and row["cameras"] == VIEWS and row["moved"] > 0):
            raise AssertionError(f"viewer export: {row}")
    expected = with_projection({"composite_fwd": VIEWER_SCENES,
                                "composite_bwd": 0, "attention_fwd": 0,
                                "attention_bwd": 0})
    if launches != expected:
        raise AssertionError(f"viewer launched {launches}, want {expected}")

    shutil.rmtree(VISUALIZE_DIR, ignore_errors=True)
    out, vis_seconds = run_module("splatformer_tpu_torch.visualize",
                                  ["--out", VISUALIZE_DIR], timeout=300)
    files = sorted(os.listdir(VISUALIZE_DIR))
    plys = [f for f in files if f.endswith(".ply")]
    emit({"phase": "visualize", "seconds": vis_seconds, "files": len(files),
          "clouds": len(plys), "stdout_tail": out[-400:]})
    # 4 algorithms x 2 heads of enc0_block0: the PCA clouds, and for the 3
    # merging ones a diff and a merge-group cloud each
    if not (len(plys) == 20 and "index.html" in files
            and "viewer.html" in files):
        raise AssertionError(f"visualize wrote {files}")
    return launches


def train_delta_check(init, got, ref):
    """Parameter updates of two runs from one ``init`` state_dict: each
    tensor's update within 2e-3 of its largest plus 5e-4 of the model's
    largest update (tensors whose gradient is rounding noise, a bias just
    before a train-mode BatchNorm, are held by the second term; the card's
    scatter-adds sum in a run-dependent order); running statistics within
    1e-5. Returns (worst error as a share of its bound, that tensor's
    name, worst statistics error)."""
    deltas = {k: (got[k] - init[k], ref[k] - init[k]) for k in ref
              if not k.endswith((".mean", ".var"))}
    gmax = max(float(dr.abs().max()) for _, dr in deltas.values())
    worst, worst_name = 0.0, ""
    for k, (dg, dr) in deltas.items():
        err = float((dg - dr).abs().max())
        bound = 2e-3 * float(dr.abs().max()) + 5e-4 * gmax
        if err / bound > worst:
            worst, worst_name = err / bound, k
        if err > bound:
            raise AssertionError(f"{k}: update differs by {err} > {bound}")
    stat_err = max(float((got[k] - ref[k]).abs().max()) for k in ref
                   if k.endswith((".mean", ".var")))
    if stat_err > 1e-5:
        raise AssertionError(f"running statistics differ by {stat_err}")
    return worst, worst_name, stat_err


def state_of(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def flat_update(init, sd):
    return torch.cat([(sd[k] - init[k]).ravel() for k in init
                      if not k.endswith((".mean", ".var"))])


def phase_train_reference():
    """A tiny model (f32 unless stated, drop_path 0, a fixed order shuffle,
    LPIPS on from seeded random weights) on the card against the CPU, from
    the same weights and data:

    * two SGD steps (lr 0.01 after the 2.0 clip), each from the same
      state on both devices (the CPU's state is copied onto the card
      before step 2): through the rasterizer's discrete culling a 1e-6 difference in one
      weight already moves this random model's next loss by ~1e-5, so only
      a shared start compares the step's own arithmetic. Losses within 1e-5
      relative; updates by train_delta_check. SGD keeps each update
      proportional to its gradient.
    * the recipe's Adam (configs/train_default.py: lr 3e-5, eps 1e-15, clip
      2.0), two steps on each device fed the same gradients (the CPU's of
      the SGD steps) from the same state: updates by train_delta_check.
      With eps 1e-15 Adam's first steps move a weight by about lr whatever
      its gradient's size, so where a whole step's gradient is rounding
      noise on both devices (a bias before a train-mode BatchNorm) the two
      would step a full lr in opposite directions; shared gradients hold
      the optimizer's own arithmetic, the card's multi-tensor ops.
    * one SGD step with bfloat16 blocks from the initial state: the loss
      within 1e-3 relative of the CPU's bf16 loss, the update at cosine >=
      0.998 with the CPU's bf16 update (the CPU's bf16 and f32 updates
      are at 0.9992, CPU run), and the card's bf16 update between 0.5 and
      2 times as far from the CPU's f32 update as the CPU's bf16 update
      is: the card perturbs the step as bf16 does, where an f32 step would
      give ~0."""
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.models.lpips import LPIPS
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import make_train_step
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    lpips_gen = torch.Generator().manual_seed(11)
    lpips_sd = {}
    for k, v in LPIPS().state_dict().items():
        draw = torch.randn(v.shape, generator=lpips_gen)
        if k.endswith("weight"):
            draw = draw / float(np.prod(v.shape[1:])) ** 0.5
        elif k.startswith("lin"):
            draw = draw.abs()
        else:
            draw = 0.01 * draw
        lpips_sd[k] = draw
    cfg = tiny_config()
    cfg.backbone.drop_path = 0.0
    perm = torch.tensor([2, 0, 3, 1])
    tcfg = train_config()
    oc = tcfg.optimizer
    device = {"cpu": "cpu", "card": "cuda"}
    batches = {r: make_request(7, 4096, 4000, 2, 64, d)
               for r, d in device.items()}
    lpips = {}
    for r, d in device.items():
        lpips[r] = LPIPS().to(d)
        lpips[r].load_state_dict(lpips_sd)

    def sgd_setup(r, compute_dtype=None):
        model = build_feature_predictor(cfg, device=device[r], seed=1,
                                        head_final_scale=0.1,
                                        compute_dtype=compute_dtype)
        opt = build_optimizer(model, {"base": 0.01, "backbone": 0.01},
                              optimizer_type="sgd")
        return model, make_train_step(model, opt, RasterizeConfig(),
                                      lpips_loss_weight=0.5, lpips=lpips[r])

    # SGD, f32
    models, steps = {}, {}
    for r in device:
        models[r], steps[r] = sgd_setup(r)
    init0 = state_of(models["cpu"])
    losses = {r: [] for r in device}
    grads, sd_step1 = [], None
    loss_err, worst, worst_name, stat_err = 0.0, 0.0, "", 0.0
    for i in range(2):
        init = state_of(models["cpu"])
        models["card"].load_state_dict(init)
        m = {r: {k: float(v) for k, v in
                 steps[r](batches[r], None, perm).items()} for r in device}
        grads.append([torch.zeros_like(p) if p.grad is None
                      else p.grad.detach().clone()
                      for p in models["cpu"].parameters()])
        for r in device:
            losses[r].append(m[r]["total_loss"])
        loss_err = max([loss_err] + [
            abs(m["card"][k] - m["cpu"][k]) / max(abs(m["cpu"][k]), 1e-12)
            for k in ("total_loss", "image_l1", "lpips")])
        sd = {r: state_of(models[r]) for r in device}
        if i == 0:
            sd_step1 = sd["cpu"]
        w, name, e = train_delta_check(init, sd["card"], sd["cpu"])
        if w > worst:
            worst, worst_name = w, name
        stat_err = max(stat_err, e)

    # the recipe's Adam, fed the same gradients on both devices
    init = state_of(models["cpu"])
    models["card"].load_state_dict(init)
    for r, d in device.items():
        adam = build_optimizer(models[r], dict(oc.lr_dict), oc.type, oc.eps,
                               oc.schedule, tcfg.total_steps,
                               oc.warmup_steps, tcfg.grad_clip_norm)
        for g in grads:
            for p, gi in zip(models[r].parameters(), g):
                p.grad = gi.to(d)
            adam.step()
    adam_worst, adam_name, _ = train_delta_check(
        init, state_of(models["card"]), state_of(models["cpu"]))

    # one SGD step with bfloat16 blocks, from the first state
    bf16_loss, bf16_update = {}, {}
    for r in device:
        model, step = sgd_setup(r, "bfloat16")
        model.load_state_dict(init0)
        bf16_loss[r] = float(step(batches[r], None, perm)["total_loss"])
        bf16_update[r] = flat_update(init0, state_of(model))
    bf16_loss_err = abs(bf16_loss["card"] - bf16_loss["cpu"]) / abs(
        bf16_loss["cpu"])
    u_card, u_cpu = bf16_update["card"], bf16_update["cpu"]
    bf16_cos = float(u_card @ u_cpu / (u_card.norm() * u_cpu.norm()))
    u_f32 = flat_update(init0, sd_step1)
    bf16_ratio = float((u_card - u_f32).norm() / (u_cpu - u_f32).norm())

    result = {"phase": "train_reference", "gaussians": 4096, "views": 2,
              "hw": 64, "sgd": "lr 0.01, clip 2.0",
              "loss_cpu": losses["cpu"], "loss_cuda": losses["card"],
              "max_rel_loss_err": loss_err,
              "worst_update_err_of_bound": worst,
              "worst_update_tensor": worst_name,
              "max_running_stat_err": stat_err,
              "adam": f"lr {oc.lr_dict['base']}, eps {oc.eps}, "
                      f"clip {tcfg.grad_clip_norm}, 2 steps",
              "adam_worst_update_err_of_bound": adam_worst,
              "adam_worst_update_tensor": adam_name,
              "bf16_loss_cpu": bf16_loss["cpu"],
              "bf16_loss_cuda": bf16_loss["card"],
              "bf16_rel_loss_err": bf16_loss_err,
              "bf16_update_cos": bf16_cos,
              "bf16_perturbation_ratio": bf16_ratio}
    emit(result)
    if loss_err > 1e-5:
        raise AssertionError(f"card and CPU losses differ: {result}")
    if not (bf16_loss_err <= 1e-3 and bf16_cos >= 0.998
            and 0.5 <= bf16_ratio <= 2.0):
        raise AssertionError(f"card and CPU bf16 steps differ: {result}")


def phase_train_reference_flash():
    """One f32 SGD step (lr 0.01 after the 2.0 clip, drop_path 0, a fixed
    order shuffle, L1 only) of the tiny enable_flash model from the same
    state on the card and on the CPU: the loss within 1e-5 relative, every
    update by train_delta_check. K3's forward and backward run once a block
    on the card, in float32."""
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import make_train_step

    cfg = tiny_flash_config()
    cfg.backbone.drop_path = 0.0
    perm = torch.tensor([2, 0, 3, 1])
    loss, sd, init = {}, {}, None
    for dev in ("cpu", "cuda"):
        model = build_feature_predictor(cfg, device=dev, seed=1,
                                        head_final_scale=0.1)
        if init is None:
            init = state_of(model)
        model.load_state_dict(init)
        opt = build_optimizer(model, {"base": 0.01, "backbone": 0.01},
                              optimizer_type="sgd")
        step = make_train_step(model, opt, RasterizeConfig())
        batch = make_request(7, 4096, 4000, 2, 64, dev)
        reset_launches()
        loss[dev] = float(step(batch, None, perm)["total_loss"])
        sd[dev] = state_of(model)
    launches = dict(LAUNCHES)  # the card's step
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    worst, worst_name, stat_err = train_delta_check(init, sd["cuda"],
                                                    sd["cpu"])
    result = {"phase": "train_reference_flash", "gaussians": 4096,
              "views": 2, "hw": 64, "sgd": "lr 0.01, clip 2.0",
              "loss_cpu": loss["cpu"], "loss_cuda": loss["cuda"],
              "rel_loss_err": loss_err,
              "worst_update_err_of_bound": worst,
              "worst_update_tensor": worst_name,
              "max_running_stat_err": stat_err, "launches": launches}
    emit(result)
    if loss_err > 1e-5:
        raise AssertionError(f"card and CPU flash losses differ: {result}")
    expected = with_projection({"composite_fwd": 1, "composite_bwd": 1,
                                "attention_fwd": 5, "attention_bwd": 5})
    if launches != expected:
        raise AssertionError(f"train_reference_flash launched {launches}, "
                             f"want {expected}")


def k3_entry(name, source, replaces, launches, totals, merge_launches,
             diag_launches, parallel_launches, f32_launches, f32_phase):
    """The kernels line's entry of a K3 kernel: its sums over one forward
    pass's launches in bfloat16, the recipe's train step's type; under
    "float32" the same for float32 with the launches ``f32_launches`` of
    the phase ``f32_phase`` that drives that type (serving_flash for the
    forward, training_flash_f32 for the backward); ``merge_launches``
    those of the merge phases, ``diag_launches`` those of the diagnostics,
    flops and viewer phases, ``parallel_launches`` those of the dp_training,
    gauss_shard and train2d phases."""
    def sums(t):
        return {"max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             "merge_launches": merge_launches[name],
             "diag_launches": diag_launches[name],
             "parallel_launches": parallel_launches[name],
             **sums(totals["bfloat16"]),
             "per": f"one forward pass: {K3_BLOCKS} launches, bfloat16"}
    entry["float32"] = {
        "launches": f32_launches[name], **sums(totals["float32"]),
        "fp32_pipe_ms": totals["float32"]["fp32_pipe_ms"],
        "per": f"one forward pass: {K3_BLOCKS} launches, float32 "
               f"(launches: {f32_phase})"}
    return entry


def phase_train_repro():
    """Two bf16 PTv3-base steps at patch 128 (the recipe's Adam, drop_path
    0.3, heads not zero-initialised so the backbone gets gradients), each
    from the same seeded weights and fresh optimizer state, with the same
    generator seed and batch. The gathers' backward adds with atomics
    (index_add_), so the two may differ in their last bits; they must stay
    within the bf16 perturbation that train_reference bounds: the loss
    within 1e-3 relative, the gradients at cosine >= 0.998."""
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import make_train_step

    tcfg = train_config()
    oc = tcfg.optimizer
    cfg = get_config()
    cfg.zeroinit = False
    batch = make_request(300, SCENE_PAD, SCENE_N, VIEWS, HW, "cuda")
    runs = []
    reset_launches()
    for _ in range(2):
        model = build_feature_predictor(cfg, device="cuda", seed=0,
                                        head_final_scale=0.01,
                                        compute_dtype="bfloat16")
        init = state_of(model)
        opt = build_optimizer(model, dict(oc.lr_dict), oc.type, oc.eps,
                              oc.schedule, tcfg.total_steps,
                              oc.warmup_steps, tcfg.grad_clip_norm)
        step = make_train_step(model, opt,
                               image_l1_loss_weight=tcfg.image_l1_loss_weight)
        gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
        loss = float(step(batch, gen)["total_loss"])
        grad = torch.cat([torch.zeros(p.numel()) if p.grad is None
                          else p.grad.detach().float().cpu().ravel()
                          for p in model.parameters()])
        runs.append((loss, grad, state_of(model), init))
        del model, opt, step
        torch.cuda.empty_cache()
    launches = dict(LAUNCHES)
    (loss1, g1, sd1, init1), (loss2, g2, sd2, init2) = runs
    same_init = all(torch.equal(init1[k], init2[k]) for k in init1)
    param_diff = max(float((sd1[k].float() - sd2[k].float()).abs().max())
                     for k in sd1)
    differing = sum(int((sd1[k] != sd2[k]).sum()) for k in sd1)
    grad_cos = float(g1 @ g2 / (g1.norm() * g2.norm()))
    result = {"phase": "train_repro", "model": "ptv3_base", "patch": 128,
              "compute_dtype": "bfloat16", "same_init": same_init,
              "loss": [loss1, loss2],
              "rel_loss_diff": abs(loss1 - loss2) / abs(loss1),
              "max_grad_diff": float((g1 - g2).abs().max()),
              "max_grad": float(g1.abs().max()), "grad_cos": grad_cos,
              "max_param_diff": param_diff,
              "state_elements_differing": differing,
              "state_elements": sum(v.numel() for v in sd1.values()),
              "bit_identical": differing == 0 and loss1 == loss2,
              "launches": launches}
    emit(result)
    if not same_init:
        raise AssertionError("the two runs did not start from one state")
    if not (result["rel_loss_diff"] <= 1e-3 and grad_cos >= 0.998):
        raise AssertionError(f"two steps from one state differ beyond the "
                             f"bf16 perturbation: {result}")
    expected = with_projection({"composite_fwd": 2, "composite_bwd": 2,
                                "attention_fwd": 0, "attention_bwd": 0})
    if launches != expected:
        raise AssertionError(f"train_repro launched {launches}, "
                             f"want {expected}")


def phase_training(flash=False, f32=False):
    """PTv3-base train steps at full width (the recipe's config and
    optimizer), with enable_flash if ``flash``, in float32 if ``f32``
    (train.bf16 off). Returns the timed steps' launches."""
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import make_train_step

    name = "training_flash" if flash else "training"
    tcfg = train_config()
    if f32:
        name += "_f32"
        tcfg.bf16 = False
    cfg = get_config()   # zeroinit=True and drop_path 0.3, as in the recipe
    cfg.backbone.enable_flash = flash
    model = build_feature_predictor(
        cfg, device="cuda", seed=0,
        compute_dtype="bfloat16" if tcfg.bf16 else None)
    n_params = sum(p.numel() for p in model.parameters())
    oc = tcfg.optimizer
    opt = build_optimizer(model, dict(oc.lr_dict), oc.type, oc.eps,
                          oc.schedule, tcfg.total_steps, oc.warmup_steps,
                          tcfg.grad_clip_norm)
    step = make_train_step(model, opt,
                           image_l1_loss_weight=tcfg.image_l1_loss_weight)
    batches = [make_request(200 + i, SCENE_PAD, SCENE_N, VIEWS, HW, "cuda")
               for i in range(TRAIN_STEPS + 1)]
    gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
    heads0 = {k: v.detach().clone() for k, v in model.named_parameters()
              if k.startswith("head_")}
    step(batches[0], gen)  # warm-up
    torch.cuda.synchronize()

    results = []
    # the type of every K3 call the steps make: the model calls the
    # wrappers by their module names, so a spy there sees each call
    from splatformer_tpu_torch.kernels import attention as k3_module
    wrappers = {n: getattr(k3_module, n)
                for n in ("attention_fwd", "attention_bwd")}
    k3_dtypes = set()

    def spy(fn):
        def call(q, *args):
            k3_dtypes.add(str(q.dtype)[6:])
            return fn(q, *args)
        return call
    for n, fn in wrappers.items():
        setattr(k3_module, n, spy(fn))
    try:
        reset_launches()  # the training path's own count starts here
        for i in range(TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = step(batches[i + 1], gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            r = {"phase": name, "step": i, "ms": ms,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
            r.update({k: float(v) for k, v in m.items()})
            results.append(r)
    finally:
        for n, fn in wrappers.items():
            setattr(k3_module, n, fn)
    launches = dict(LAUNCHES)
    moved = max(float((p.detach() - heads0[k]).abs().max())
                for k, p in model.named_parameters() if k in heads0)
    for r in results:
        emit(r)
    emit({"phase": f"{name}_summary", "model": "ptv3_base",
          "patch": 1024 if flash else 128,
          "compute_dtype": "bfloat16" if tcfg.bf16 else "float32",
          "params": n_params, "steps": TRAIN_STEPS, "launches": launches,
          "k3_dtypes": sorted(k3_dtypes),
          "ms_mean": sum(r["ms"] for r in results) / TRAIN_STEPS,
          "peak_mem_gb": max(r["peak_mem_gb"] for r in results),
          "head_max_update": moved})
    for r in results:
        if not (all(np.isfinite(r[k]) for k in
                    ("total_loss", "image_l1", "train_psnr"))
                and r["num_dropped"] == 0
                and r["peak_mem_gb"] < PEAK_MEM_GB):
            raise AssertionError(f"bad train step: {r}")
    if not moved > 0:
        raise AssertionError("the heads did not move")
    k3 = K3_BLOCKS * TRAIN_STEPS if flash else 0
    expected = with_projection({"composite_fwd": TRAIN_STEPS,
                                "composite_bwd": TRAIN_STEPS,
                                "attention_fwd": k3, "attention_bwd": k3})
    if launches != expected:
        raise AssertionError(f"{name} launched {launches}, want {expected}")
    if f32 and k3_dtypes != {"float32"}:
        raise AssertionError(f"{name} ran K3 in {sorted(k3_dtypes)}, want "
                             "float32 only")
    return launches


LOOP_DIR = "build/chip_smoke_loop"
LOOP_STEPS, LOOP_RESUMED_TO, LOOP_EVAL = 20, 25, 10


def phase_loop():
    """run_training twice on one output directory (see the module
    docstring); returns the two calls' summed launch counts."""
    import shutil

    from splatformer_tpu_torch.configs import build_full_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.lpips import write_synthetic_weights
    from splatformer_tpu_torch.training import checkpoints as ckpt_lib
    from splatformer_tpu_torch.training.loop import run_training

    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    lpips_path = f"{LOOP_DIR}/lpips_vgg.npz"
    write_synthetic_weights(lpips_path)
    n_scenes = 2
    cfg = build_full_config(overrides=[
        f"dataset.n_scenes={n_scenes}", f"dataset.n_gaussians={SCENE_N}",
        f"dataset.pad_to={SCENE_PAD}", f"dataset.max_gs_num={SCENE_PAD}",
        f"dataset.image_size={HW}", f"dataset.image_per_scene={VIEWS}",
        "train.log_interval=1", f"train.eval_interval={LOOP_EVAL}",
        # saves at opt_step + 1 = save_interval: step 10
        f"train.save_interval={LOOP_EVAL + 1}",
        f"train.lpips_weights_path='{lpips_path}'"])
    if not (cfg.train.bf16 and cfg.train.auto_raster_budget
            and cfg.train.lpips_loss_weight == 1.0):
        raise AssertionError(f"loop config: {cfg.train}")
    out = f"{LOOP_DIR}/run"
    calls, launches = [], dict.fromkeys(LAUNCHES, 0)
    for steps in (LOOP_STEPS, LOOP_RESUMED_TO):
        start = ckpt_lib.latest_step(f"{out}/checkpoints") or 0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _, _, rcfg, lpips_fn = run_training(cfg, out, max_steps=steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(f"{out}/history.json") as f:
            history = json.load(f)
        for k, v in LAUNCHES.items():
            launches[k] += v
        evals = [s for s in range(start, steps)
                 if s > 0 and s % LOOP_EVAL == 0]
        images = [s for s in range(start, steps)
                  if s % cfg.train.log_image_interval == 0]
        calls.append({
            "phase": "loop", "call": len(calls), "start_step": start,
            "first_logged_step": history[0]["step"] if history else None,
            "end_step": state.step, "seconds": seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "raster": {"tiers": list(rcfg.tiers),
                       "tiles_per_gauss": rcfg.tiles_per_gauss,
                       "max_intersects": rcfg.max_intersects},
            "lpips_on": lpips_fn is not None, "evals": evals,
            "launches": dict(LAUNCHES),
            # GT of every scene, each step, the refined and the input render
            # of every test scene (min(4, n_scenes)) at each eval, and the
            # train images
            "expected_k1": n_scenes + (steps - start)
            + 2 * min(4, n_scenes) * len(evals) + len(images),
            "expected_k2": steps - start,
            "history": history})
    with open(f"{out}/eval.csv") as f:
        rows = [line.strip().split(",") for line in f]
    with open(f"{out}/best.json") as f:
        best = json.load(f)
    for c in calls:
        emit({**{k: v for k, v in c.items() if k != "history"},
              **{k: [h[k] for h in c["history"]]
                 for k in ("total_loss", "lpips", "train_psnr", "num_dropped",
                           "steps_per_s")}})
    emit({"phase": "loop_summary", "model": "ptv3_base", "bf16": True,
          "eval_csv": rows, "launches": launches, "best": best,
          "checkpoints": sorted(os.listdir(f"{out}/checkpoints"))})
    for c in calls:
        for h in c["history"]:
            if not (all(np.isfinite(h[k]) for k in
                        ("total_loss", "image_l1", "lpips", "train_psnr"))
                    and h["num_dropped"] == 0):
                raise AssertionError(f"bad loop step: {h}")
        got = (c["launches"]["composite_fwd"], c["launches"]["composite_bwd"])
        if got != (c["expected_k1"], c["expected_k2"]):
            raise AssertionError(f"loop call {c['call']} launched {got}, "
                                 f"want {(c['expected_k1'], c['expected_k2'])}")
        if not c["lpips_on"] or c["end_step"] != c["history"][-1]["step"] + 1:
            raise AssertionError(f"loop call {c['call']}: {c['end_step']}")
    if [c["start_step"] for c in calls] != [0, LOOP_STEPS] or [
            c["first_logged_step"] for c in calls] != [0, LOOP_STEPS]:
        raise AssertionError("the second call did not resume at step "
                             f"{LOOP_STEPS}: {[c['start_step'] for c in calls]}")
    if ([r[:2] for r in rows[1:]] != [["synthetic", "10"], ["synthetic", "20"]]
            or not all(np.isfinite(float(x)) for r in rows[1:]
                       for x in r[2:])):
        raise AssertionError(f"eval.csv rows: {rows}")
    return launches


# the per-scene fit at tests/test_fit_gs.py's size: one densify (after
# step 40), card against CPU
FIT_REF = dict(steps=60, capacity=1024, warmup_steps=20, densify_every=20,
               densify_stop=40, reset_opacity_every=0, sh_degree=1,
               sh_degree_interval=20, densify_budget_frac=0.05,
               lr_means=2e-3, lr_means_final=2e-4)
FIT_LOSS_RTOL = 1e-5
# whole fits, card against CPU, one a seed (init, view draws and offset
# directions); they part after a few steps (Adam's eps of 1e-15 turns
# rounding noise into +-lr steps), and must still agree this well in PSNR
# and in the last step's loss, with the same live count. Read on an H100
# at seeds 0-2: PSNR at most 3.2e-5 dB and the loss 4.0e-6 relative apart;
# the faults below 0.48 dB (no densify), 2.2 dB (flat means lr) and
# 2.8e-4 dB with the loss 1.5e-4 relative apart (Adam eps 1e-8)
FIT_SEEDS = (0, 1, 2)
FIT_PSNR_DB = 1e-3
FIT_LAST_LOSS_RTOL = 3e-5
# faults planted by a setting (a card fit of seed 0 read against the sound
# CPU fit): each must fall outside the agreement above
FIT_FAULTS = {"no_densify": dict(densify_every=10 ** 6),
              "means_lr_flat": dict(lr_means_final=FIT_REF["lr_means"]),
              "adam_eps_1e-8": dict(adam_eps=1e-8)}


def phase_fit_reference():
    """The per-scene fit, card against CPU: one step's loss and gradients
    from one state, densify's slot order on scores with ties, and whole
    60-step fits from fit_gaussians' init at FIT_SEEDS (shared view draws
    and offset directions) by their PSNR, last loss and live count, beside
    the planted FIT_FAULTS. Returns the card's launch counts."""
    import dataclasses

    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training import fit_gs

    rcfg = RasterizeConfig(max_intersects=2 ** 13, tiles_per_gauss=16)
    cfg = fit_gs.FitConfig(**FIT_REF)
    gt = random_scene(np.random.default_rng(11), 384, device="cpu")
    gt = gt.replace(scales=torch.clamp(gt.scales + 1.5, -5.0, -2.5),
                    opacities=gt.opacities + 2.0)
    cams = {"cpu": orbit_cameras(5, 48, 48, device="cpu"),
            "cuda": orbit_cameras(5, 48, 48, device="cuda")}
    with torch.no_grad():
        target = torch.clamp(render_images(gt, cams["cpu"], torch.zeros(3),
                                           rcfg)[0], 0.0, 1.0)
    images = {"cpu": target, "cuda": target.cuda()}
    view = int(np.random.default_rng(0).integers(5))  # fit_gaussians' first
    band = torch.ones(3)
    # one state for both devices: init_state's, its live quats, scales and
    # SH spread (the identity quats and isotropic scales of the init get
    # no rotation gradient, and SH none before its band unlocks)
    base = fit_gs.init_state(cfg, n_init=256, seed=0, device="cpu")
    live = base.mask.numpy()
    rng = np.random.default_rng(9)
    host = {k: p.detach().numpy().copy() for k, p in base.params.items()}
    host["quats"][live] = rng.normal(size=(live.sum(), 4))
    host["scales"][live] += rng.normal(0, 0.4, (live.sum(), 3))
    host["features_rest"][live] = rng.normal(0, 0.2, (live.sum(), 3, 3))

    def fit(dev, fit_cfg, seed):
        t0 = time.perf_counter()
        scene, m = fit_gs.fit_gaussians(images[dev], cams[dev], fit_cfg,
                                        rcfg, seed=seed)
        ev = fit_gs.eval_fit(scene, images[dev], cams[dev], rcfg)
        return {"psnr": ev["psnr"], "fit_loss": m["loss"],
                "n_gauss": m["n_gauss"],
                "seconds": time.perf_counter() - t0}

    def agreement(got, ref):
        return {"psnr_gap_db": abs(got["psnr"] - ref["psnr"]),
                "fit_loss_rel_gap": abs(got["fit_loss"] - ref["fit_loss"])
                / abs(ref["fit_loss"]),
                "n_gauss": [ref["n_gauss"], got["n_gauss"]]}

    def agrees(a):
        return (a["psnr_gap_db"] <= FIT_PSNR_DB
                and a["fit_loss_rel_gap"] <= FIT_LAST_LOSS_RTOL
                and a["n_gauss"][0] == a["n_gauss"][1])

    out = {}
    reset_launches()
    for dev in ("cpu", "cuda"):
        state = fit_gs.init_state(cfg, n_init=256, seed=0, device=dev)
        with torch.no_grad():
            for k, v in host.items():
                state.params[k].copy_(torch.from_numpy(v))
        loss, _, _ = fit_gs.fit_loss(cfg, rcfg, state.params, state.mask,
                                     cams[dev].select(view),
                                     images[dev][view],
                                     torch.zeros(3, device=dev),
                                     band.to(dev))
        grads = torch.autograd.grad(loss, [state.params[k]
                                           for k in fit_gs.ATTRS])
        # densify's ranking on scores with ties (lax.top_k's order)
        score = torch.as_tensor(np.random.default_rng(3).integers(
            0, 7, cfg.capacity).astype(np.float32)).to(dev)
        # densify on forged statistics with ties, offsets from the seed
        acc = np.where(live, np.random.default_rng(4).integers(
            1, 4, cfg.capacity) * 1e-6, 0.0).astype(np.float32)
        state.grad_accum = torch.from_numpy(acc).to(dev)
        state.grad_count = torch.ones(cfg.capacity, device=dev)
        n_new = fit_gs.densify(cfg, state, torch.Generator().manual_seed(0))
        out[dev] = {"loss": float(loss.detach()),
                    "grads": [g.cpu() for g in grads],
                    "top": fit_gs.top_slots(score, 200)[1].cpu(),
                    "densify_mask": state.mask.cpu(), "n_new": int(n_new)}
    fits = []
    for seed in FIT_SEEDS:
        ref, got = fit("cpu", cfg, seed), fit("cuda", cfg, seed)
        fits.append({"seed": seed, "psnr_cpu": ref["psnr"],
                     "psnr_cuda": got["psnr"], "fit_loss_cpu": ref["fit_loss"],
                     "fit_loss_cuda": got["fit_loss"],
                     "seconds_cpu": ref["seconds"],
                     "seconds_cuda": got["seconds"], **agreement(got, ref)})
        if seed == FIT_SEEDS[0]:
            sound = ref
    faults = {name: agreement(fit("cuda", dataclasses.replace(cfg, **kw), 0),
                              sound)
              for name, kw in FIT_FAULTS.items()}
    launches = dict(LAUNCHES)  # the card's: the CPU takes plain versions
    cpu, gpu = out["cpu"], out["cuda"]
    grad_err = {k: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for k, a, b in zip(fit_gs.ATTRS, gpu["grads"], cpu["grads"])}
    result = {"phase": "fit_reference", "capacity": cfg.capacity,
              "views": 5, "hw": 48, "steps": cfg.steps,
              "loss_cpu": cpu["loss"], "loss_cuda": gpu["loss"],
              "grad_err_rel": grad_err,
              "slot_order_equal": bool(torch.equal(cpu["top"], gpu["top"])),
              "densify_mask_equal": bool(torch.equal(cpu["densify_mask"],
                                                     gpu["densify_mask"])),
              "densify_added": [cpu["n_new"], gpu["n_new"]],
              "fits": fits, "faults": faults, "launches": launches}
    emit(result)
    if not (abs(gpu["loss"] - cpu["loss"]) <= FIT_LOSS_RTOL * abs(cpu["loss"])
            and all(e <= K2_TOL for e in grad_err.values())
            and result["slot_order_equal"] and result["densify_mask_equal"]
            and cpu["n_new"] == gpu["n_new"] > 0
            and all(agrees(f) and np.isfinite(f["fit_loss_cuda"])
                    for f in fits)):
        raise AssertionError(f"card and CPU fits disagree: {result}")
    caught = {name: not agrees(a) for name, a in faults.items()}
    if not all(caught.values()):
        raise AssertionError(f"planted fit faults pass as sound: {caught}")
    # the card's loss render, then per fit its steps and one eval_fit render
    n_fits = len(FIT_SEEDS) + len(FIT_FAULTS)
    want = with_projection({"composite_fwd": 1 + n_fits * (cfg.steps + 1),
                            "composite_bwd": 1 + n_fits * cfg.steps,
                            "attention_fwd": 0, "attention_bwd": 0})
    if launches != want:
        raise AssertionError(f"fit_reference launched {launches}, want {want}")
    return launches


def hold_composite(e, hw, seed):
    """K1 and K2 against their plain versions on one view's entries ``e``
    (a cotangent drawn from ``seed``): errors, walks and the kernels'
    times."""
    tiles_x = hw // 16
    return {"num_entries": int(e.bins.num_entries),
            "num_dropped": int(e.bins.num_dropped),
            **hold_kernels(e.packed_t, e.tile_start, tiles_x,
                           tiles_x * tiles_x, seed)}


def hold_kernels(packed_t, tile_start, tiles_x, tiles_img, seed):
    """K1 and K2 against their plain versions on packed entries over
    images of ``tiles_img`` tiles, ``tiles_x`` wide (a cotangent drawn
    from ``seed``): errors, walks and the kernels' times."""
    from splatformer_tpu_torch.kernels.composite import (composite_bwd,
                                                         composite_bwd_plain,
                                                         composite_fwd,
                                                         composite_fwd_plain)
    args = (packed_t, tile_start, tiles_x, tiles_img)
    out_k, walked_k = composite_fwd(*args)
    out_p, walked_p = composite_fwd_plain(*args)
    gen = torch.Generator(device=packed_t.device).manual_seed(seed)
    g_out = torch.randn(out_k.shape, generator=gen, device=packed_t.device)
    bargs = args + (out_k, walked_k, g_out)
    d_k = composite_bwd(*bargs)
    d_p = composite_bwd_plain(*bargs)
    replayed = replayed_columns(tile_start, walked_k, packed_t.shape[1])
    return {
        "walk_max": int(walked_k.max()),
        "walk_mean": float(walked_k.float().mean()),
        "k1_max_abs_err": float((out_k - out_p).abs().max()),
        "walked_mismatches": int((walked_k != walked_p).sum()),
        "k2_row_rel_err": [float((d_k[r] - d_p[r]).abs().max())
                           / max(float(d_p[r].abs().max()), 1e-30)
                           for r in range(9)],
        "k2_max_abs_err": float((d_k - d_p).abs().max()),
        "stray_nonzeros": int((d_k[:, ~replayed] != 0).sum()
                              + (d_k[9:] != 0).sum()),
        "k1_ms": cuda_ms(lambda: composite_fwd(*args), 20),
        "k2_ms": cuda_ms(lambda: composite_bwd(*bargs), 20)}


def phase_fit_kernels():
    """K1 and K2 against their plain versions at the shapes the factory's
    fit gives them: one 256^2 input view, binned with the factory's tiers
    and max_intersects, of the ground-truth scene (98,304 Gaussians) and of
    the scene fitted from it at the factory's settings (65,536 slots, 300
    steps), whose surfaces make the walks longer."""
    from splatformer_tpu_torch.data.procgen import make_gt_scene, ring_cameras
    from splatformer_tpu_torch.make_ood_benchmark import (
        SH_C0, build_configs, parse_args, sfm_like_seed_points)
    from splatformer_tpu_torch.ops.render import (prepare_entries,
                                                  render_images)
    from splatformer_tpu_torch.training import fit_gs

    args = parse_args(["--out", FACTORY_DIR] + FACTORY_FLAGS)
    fit_cfg, rcfg = build_configs(args)
    gt = make_gt_scene(0, n_gauss=args.n_gauss)
    elevs = [float(x) for x in args.in_elevations.split(",")]
    cams = ring_cameras(elevs, args.n_az_in, args.hw, args.hw,
                        az_jitter=0.15, seed=0)
    with torch.no_grad():
        images = torch.clamp(render_images(gt, cams, torch.zeros(
            3, device="cuda"), rcfg)[0], 0.0, 1.0)
    pts, cols, _ = sfm_like_seed_points(
        gt.means.cpu().numpy(), gt.features_dc.cpu().numpy() * SH_C0 + 0.5,
        cams, args.hw, args.seed_points, 0)
    fitted, m = fit_gs.fit_gaussians(images, cams, fit_cfg, rcfg, seed=0,
                                     points=pts, colors=cols)
    result = {"phase": "fit_kernels", "hw": args.hw,
              "capacity": fit_cfg.capacity, "fit_steps": fit_cfg.steps,
              "fitted_live": m["n_gauss"]}
    with torch.no_grad():
        for name, scene in (("gt", gt), ("fitted", fitted)):
            result[name] = hold_composite(
                prepare_entries(scene, cams.select(0), rcfg), args.hw, 5)
    emit(result)
    for name in ("gt", "fitted"):
        r = result[name]
        if not (r["k1_max_abs_err"] <= K1_TOL and r["walked_mismatches"] == 0
                and max(r["k2_row_rel_err"]) <= K2_TOL
                and r["stray_nonzeros"] == 0 and r["num_dropped"] == 0
                and r["num_entries"] > 0):
            raise AssertionError(f"K1 or K2 disagrees at the fit's shapes "
                                 f"({name}): {result}")


FACTORY_DIR = "build/chip_smoke_factory"
# scripts/run_oodbench_scale.sh's generation flags, 2 + 1 scenes of 300
# fit steps (warm-up 100, densify_stop 200: one densify)
FACTORY_FLAGS = ["--hw", "256", "--n_gauss", "98304", "--capacity", "65536",
                 "--fit_steps", "300", "--seed_points", "49152",
                 "--densify_budget_frac", "0.08", "--fit_warmup", "100",
                 "--max_intersects", "524288", "--tiers", "8,32768,24,4096",
                 "--n_train_scenes", "2", "--n_test_scenes", "1",
                 "--log_every", "100"]
FACTORY_STEPS, FACTORY_EVAL = 10, 5
PHASE_RE = re.compile(r"^\s+\[(\w+): ([0-9.]+)s\]$")


def run_module(module, args, cwd=None, timeout=600):
    """``python -m module args`` in its own process, from ``cwd`` with this
    checkout on the path; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("."))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_factory():
    """The data factory at the scale tier's widths in its own process, a
    second call that skips the done scenes, run_training on its folder,
    then --only_eval --compare_with_input through the CLI in its own
    process. Returns the factory's launch counts."""
    import shutil

    from splatformer_tpu_torch.configs import build_full_config
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.models.lpips import write_synthetic_weights
    from splatformer_tpu_torch.training.loop import run_training

    shutil.rmtree(FACTORY_DIR, ignore_errors=True)
    data = os.path.abspath(f"{FACTORY_DIR}/data")
    stdout, seconds = run_module("splatformer_tpu_torch.make_ood_benchmark",
                                 ["--out", data] + FACTORY_FLAGS)
    scenes, cur, fit_losses = [], None, []
    launches = peak_gib = None
    for line in stdout.splitlines():
        m = PHASE_RE.match(line)
        if m:
            if cur is None:
                cur = {"phases_s": {}}
            cur["phases_s"][m.group(1)] = float(m.group(2))
        elif line.startswith("{"):
            cur.update(json.loads(line))
            scenes.append(cur)
            cur = None
        elif line.startswith("fit step "):
            fit_losses.append(float(re.search(r"'loss': ([^,}]+)",
                                              line).group(1)))
        elif line.startswith("kernel launches: "):
            launches = json.loads(line[len("kernel launches: "):])
        elif line.startswith("peak device memory: "):
            peak_gib = float(line.split()[3])
    steps = int(FACTORY_FLAGS[FACTORY_FLAGS.index("--fit_steps") + 1])
    for s in scenes:
        s["fit_ms_per_step"] = 1e3 * s["phases_s"]["fit"] / steps
    again, _ = run_module("splatformer_tpu_torch.make_ood_benchmark",
                          ["--out", data] + FACTORY_FLAGS)
    layout = sorted(
        os.path.relpath(os.path.join(d, f), data)
        for d, _, files in os.walk(data) for f in files
        if not f.endswith(".png"))
    n_images = {s: len(os.listdir(f"{data}/{s}/colmap/{n}/images"))
                for s, n in (("train", "scene00000"), ("train", "scene00001"),
                             ("test", "scene10000"))}

    # the loop on the factory's folder: PTv3-base, bf16, LPIPS
    lpips_path = f"{FACTORY_DIR}/lpips_vgg.npz"
    write_synthetic_weights(lpips_path)
    folders = {"oodbench_scale": (f"{data}/test/nerfstudio",
                                  f"{data}/test/colmap")}
    overrides = [
        f"dataset.train.nerfstudio_folder='{data}/train/nerfstudio'",
        f"dataset.train.colmap_folder='{data}/train/colmap'",
        f"dataset.test.folders={folders!r}",
        "train.log_interval=1", f"train.eval_interval={FACTORY_EVAL}",
        f"train.lpips_weights_path='{os.path.abspath(lpips_path)}'"]
    cfg = build_full_config(dataset="oodbench_scale", overrides=overrides)
    run = os.path.abspath(f"{FACTORY_DIR}/run")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _, _, rcfg, lpips_fn = run_training(cfg, run,
                                               max_steps=FACTORY_STEPS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = dict(LAUNCHES)
    loop_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(f"{run}/history.json") as f:
        history = json.load(f)
    with open(f"{run}/eval.csv") as f:
        run_rows = [line.strip().split(",") for line in f]
    args = ["--dataset", "oodbench_scale", "--output_dir", run,
            "--only_eval", "--compare_with_input"]
    for o in overrides:
        args += ["--override", o]
    _, eval_s = run_module("splatformer_tpu_torch.train", args,
                           cwd=FACTORY_DIR)
    with open(f"{FACTORY_DIR}/eval.csv") as f:
        cli_rows = [line.strip().split(",") for line in f]

    evals = [s for s in range(FACTORY_STEPS)
             if s > 0 and s % FACTORY_EVAL == 0]
    images = [s for s in range(FACTORY_STEPS)
              if s % cfg.train.log_image_interval == 0]
    n_test = len(os.listdir(f"{data}/test/nerfstudio"))
    want_fit = with_projection({
        "composite_fwd": (2 + steps + 2) * len(scenes),
        "composite_bwd": steps * len(scenes),
        "attention_fwd": 0, "attention_bwd": 0})
    # a step's render, the refined and the input render of every test
    # scene at each eval, and the train images (the loaders render no GT)
    want_loop = with_projection({
        "composite_fwd": FACTORY_STEPS + 2 * n_test * len(evals)
        + len(images), "composite_bwd": FACTORY_STEPS,
        "attention_fwd": 0, "attention_bwd": 0})
    result = {
        "phase": "factory", "seconds": seconds, "scenes": scenes,
        "peak_mem_gib": peak_gib, "launches": launches,
        "fit_losses": fit_losses, "skip_lines": again.count("[skip]"),
        "layout": layout, "images": n_images,
        "loop": {"seconds": loop_s, "end_step": state.step,
                 "peak_mem_gib": loop_peak, "launches": loop_launches,
                 "raster": {"tiers": list(rcfg.tiers),
                            "tiles_per_gauss": rcfg.tiles_per_gauss,
                            "max_intersects": rcfg.max_intersects},
                 "lpips_on": lpips_fn is not None,
                 **{k: [h[k] for h in history]
                    for k in ("total_loss", "lpips", "num_dropped",
                              "steps_per_s")}},
        "run_eval_csv": run_rows, "only_eval_seconds": eval_s,
        "only_eval_csv": cli_rows}
    emit(result)
    names = [("train", "scene00000"), ("train", "scene00001"),
             ("test", "scene10000")]
    want_layout = sorted(
        [f"{s}/nerfstudio/{n}/splatfacto/nerfstudio_models/"
         "step-000001999.ckpt" for s, n in names]
        + [f"{s}/colmap/{n}/sparse/0/{f}.bin" for s, n in names
           for f in ("cameras", "images", "points3D")]
        + ["generation_summary.jsonl"])
    if layout != want_layout or set(n_images.values()) != {14 + 9}:
        raise AssertionError(f"factory layout: {layout} {n_images}")
    if result["skip_lines"] != 3 or "wrote 0 scenes" not in again:
        raise AssertionError(f"second factory call: {again}")
    if not (len(scenes) == 3 and len(fit_losses) == 9
            and all(np.isfinite(fit_losses))):
        raise AssertionError(f"factory fits: {scenes} {fit_losses}")
    for s in scenes:
        if not s["fit_psnr_input_views"] > s["fit_psnr_ood_views"]:
            raise AssertionError(f"fit PSNR on the input views not above "
                                 f"the OOD views': {s}")
    if launches != want_fit:
        raise AssertionError(f"factory launched {launches}, want {want_fit}")
    if loop_launches != want_loop:
        raise AssertionError(f"factory loop launched {loop_launches}, want "
                             f"{want_loop}")
    for h in history:
        if not (np.isfinite(h["total_loss"]) and h["num_dropped"] == 0):
            raise AssertionError(f"bad factory loop step: {h}")
    if not (state.step == FACTORY_STEPS and lpips_fn is not None
            and [r[:2] for r in run_rows[1:]] == [["oodbench_scale",
                                                   str(FACTORY_EVAL)]]
            and all(np.isfinite(float(x)) for x in run_rows[1][2:])):
        raise AssertionError(f"factory loop: {state.step} {run_rows}")
    if not (len(cli_rows) == 2 and cli_rows[1][0] == "oodbench_scale"
            and all(np.isfinite(float(x)) for x in cli_rows[1][1:4])):
        raise AssertionError(f"only_eval eval.csv: {cli_rows}")
    return launches


JPEG_DIR = "tests/data/jpeg"
JPEG_FIT_DIR = "build/chip_smoke_jpeg"
JPEG_FIT_STEPS = 400
JPEG_ROUNDS = 5      # timed rounds of the compiled decoder and the batch
FIT_STEP_RE = re.compile(r"^fit step (\d+): .*'loss': ([^,}]+)")


CPU_BRAND_SRC = r"""
#include <cpuid.h>
#include <cstdio>
#include <cstring>
int main() {
  unsigned r[12] = {0};
  for (unsigned i = 0; i < 3; ++i)
    __get_cpuid(0x80000002u + i, &r[4 * i], &r[4 * i + 1], &r[4 * i + 2],
                &r[4 * i + 3]);
  char s[49];
  std::memcpy(s, r, 48);
  s[48] = 0;
  std::puts(s);
}
"""


def host_cpu():
    """The host CPU: /proc/cpuinfo's model name, the CPUID brand string
    (a virtualised /proc/cpuinfo may say "unknown"), and the core count."""
    import tempfile

    from splatformer_tpu_torch.kernels.build import cxx_path
    with open("/proc/cpuinfo") as f:
        names = [line.split(":", 1)[1].strip() for line in f
                 if line.startswith("model name")]
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "brand.cpp"), os.path.join(tmp, "brand")
        with open(src, "w") as f:
            f.write(CPU_BRAND_SRC)
        subprocess.run([str(cxx_path()), "-o", exe, src], check=True,
                       timeout=120)
        brand = subprocess.run([exe], check=True, capture_output=True,
                               text=True, timeout=60).stdout.strip()
    return {"proc_cpuinfo_model": names[0] if names else None,
            "cpuid_brand": brand, "cores": os.cpu_count()}


def phase_jpeg():
    """The JPEG decoders against the manifest and their times on the host,
    then fit_3dgs on the JPEG capture in its own process. Returns the fit's
    launch counts."""
    import hashlib

    from splatformer_tpu_torch.data import image_io, jpeg

    def sha(u8):
        return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()

    with open(f"{JPEG_DIR}/manifest.json") as f:
        manifest = json.load(f)
    plain_s, mismatched, refused = {}, [], {}
    for rel, entry in sorted(manifest.items()):
        with open(f"{JPEG_DIR}/{rel}", "rb") as f:
            data = f.read()
        if "raises" in entry:
            for fn in (jpeg.decode_jpeg, jpeg.decode_jpeg_plain):
                try:
                    fn(data)
                except NotImplementedError as e:
                    if entry["match"] not in str(e):
                        mismatched.append((rel, fn.__name__, str(e)))
                    refused[rel] = str(e)
                else:
                    mismatched.append((rel, fn.__name__, "decoded"))
            continue
        t0 = time.perf_counter()
        plain = jpeg.decode_jpeg_plain(data)
        plain_s[rel] = time.perf_counter() - t0
        for name, u8 in (("plain", plain), ("compiled",
                                            jpeg.decode_jpeg(data))):
            if list(u8.shape) != entry["shape"] or sha(u8) != entry["sha256"]:
                mismatched.append((rel, name, sha(u8)))
    views = sorted(r for r in manifest if r.startswith("capture/images/"))
    paths = [f"{JPEG_DIR}/{r}" for r in views]
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    mpix = sum(int(np.prod(manifest[r]["shape"][:2])) for r in views) / 1e6

    def median_s(fn):
        times = []
        for _ in range(JPEG_ROUNDS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))
    compiled_s = median_s(lambda: [jpeg.decode_jpeg(b) for b in blobs])
    serial_s = median_s(lambda: [image_io.decode_image(p) for p in paths])
    batch_s = median_s(lambda: image_io.decode_batch(paths))
    batch = image_io.decode_batch(paths)
    serial = np.stack([image_io.decode_image(p) for p in paths])
    result = {
        "phase": "jpeg", "host_cpu": host_cpu(),
        "fixtures": len(manifest), "refused": refused,
        "mismatched": mismatched, "capture_views": len(views),
        "capture_mpix": mpix,
        "plain_ms_per_mpix": 1e3 * sum(plain_s[r] for r in views) / mpix,
        "compiled_ms_per_mpix": 1e3 * compiled_s / mpix,
        "serial_decode_image_ms": 1e3 * serial_s,
        "decode_batch_ms": 1e3 * batch_s,
        "decode_batch_speedup": serial_s / batch_s,
        "decode_batch_equal": bool(np.array_equal(batch, serial))}

    capture = f"{JPEG_DIR}/capture"
    out = f"{JPEG_FIT_DIR}/scene.npz"
    stdout, seconds = run_module("splatformer_tpu_torch.fit_3dgs", [
        "--colmap", capture, "--out", out, "--steps", str(JPEG_FIT_STEPS),
        "--log_every", "50", "--capacity", "65536",
        "--max_intersects", str(2 ** 21)])
    losses, launches, psnr = [], None, None
    for line in stdout.splitlines():
        m = FIT_STEP_RE.match(line)
        if m:
            losses.append(float(m.group(2)))
        elif line.startswith("kernel launches: "):
            launches = json.loads(line[len("kernel launches: "):])
        elif line.startswith("fit:"):
            psnr = float(re.search(r"train-view: \{'psnr': ([^,}]+)",
                                   line).group(1))
    z = np.load(out)
    train_paths = [str(p) for p in z["train_imgs_path"]]
    want = with_projection({"composite_fwd": JPEG_FIT_STEPS + 1,
                            "composite_bwd": JPEG_FIT_STEPS,
                            "attention_fwd": 0, "attention_bwd": 0})
    result.update({"fit_seconds": seconds, "fit_losses": losses,
                   "fit_train_view_psnr": psnr, "fit_launches": launches,
                   "fit_n_gauss": int(len(z["gs/means"])),
                   "fit_train_views": len(train_paths)})
    emit(result)
    if mismatched or not refused:
        raise AssertionError(f"JPEG decoders against the manifest: "
                             f"{mismatched}")
    if not result["decode_batch_equal"]:
        raise AssertionError("decode_batch differs from serial decode_image")
    if not (len(losses) == JPEG_FIT_STEPS // 50 and np.all(np.isfinite(losses))
            and losses[-1] < losses[0] and psnr is not None
            and np.isfinite(psnr)):
        raise AssertionError(f"fit_3dgs on the JPEG capture: {losses} {psnr}")
    if not (len(train_paths) == 10
            and all(p.endswith(".jpg") for p in train_paths)):
        raise AssertionError(f"fit_3dgs npz views: {train_paths}")
    if launches != want:
        raise AssertionError(f"fit_3dgs launched {launches}, want {want}")
    return launches


def phase_bench():
    """The port bench in its own process, as a user runs it."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "splatformer_tpu_torch.bench"],
        capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    partial, final = json.loads(lines[0]), json.loads(lines[-1])
    emit({"phase": "bench", "seconds": seconds, "lines": len(lines),
          "final": final, "stderr_tail": proc.stderr[-600:]})
    extra = final["extra"]
    if not (len(lines) == 2 and partial["extra"].get("partial") is True
            and set(final) == {"metric", "value", "unit", "vs_baseline",
                               "extra"}
            and final["metric"] == "rasterize_fwd_bwd_mrays_per_s_per_chip"
            and final["value"] > 0
            and extra["train_step_iters_per_s_per_chip"] > 0
            and extra["device"]["platform"] == "gpu"
            and extra["device"]["nvidia_smi"]):
        raise AssertionError(f"bench output: {lines}")


# ---------------------------------------------------------------------------
# parallel/: scene data parallelism, the Gaussian-sharded render, 2-D steps
# ---------------------------------------------------------------------------

GAUSS_FWD_TOL = 2e-5          # tests/test_gauss_shard.py's atol
GAUSS_GRAD_ATOL, GAUSS_GRAD_RTOL = 1e-5, 5e-3   # its row-block gradients
TRAIN2D_LOSS_RTOL = 1e-6
TRAIN2D_GRAD_COS = 0.99999
PAYLOAD_BYTES = 8 + 9 * 4     # an exchanged entry: merge key, payload


def init_world_of_one():
    """An NCCL process group of world size 1 (rank 0, a file store in a
    temporary directory, removed by the caller after
    destroy_process_group); returns the directory."""
    import datetime
    import tempfile

    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    return tmp


def deterministic_step(step, batch, gen):
    """One train step under torch.use_deterministic_algorithms (the
    gathers' backward, index_add_, otherwise adds atomically, so that two
    runs of one step differ in their last bits: train_repro). Returns (its
    metrics as floats, its launches, its ms, the peak GB, the warnings of
    the deterministic mode)."""
    import warnings

    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in step(batch, gen).items()}
            torch.cuda.synchronize()
            det_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.use_deterministic_algorithms(False)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (metrics, launches, det_ms, peak,
            sorted({str(w.message)[:160] for w in caught}))


def timed_step(step, batch, gen):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_dp_training(flash=False):
    """The data-parallel train step (``mesh`` from the world of one
    process, the model's BatchNorm synced over its data group) against the
    plain step, PTv3-base at full width with the recipe (bf16, drop_path
    0.3, Adam), from one seeded state, one generator seed and one batch,
    each under the deterministic mode: loss, every gradient, the updated
    parameters and the BatchNorm statistics bit-identical; the launches of
    a step unchanged (K1 1, K2 1, K3 22 each with ``flash``); the step's
    ms both ways (3 more steps each, in turns, outside the deterministic
    mode) and the gradient all-reduce's ms (and its NCCL call's alone, on
    one flat buffer); reduce_metric_sums and sync_processes at world size
    1. Returns the DP step's launches."""
    import torch.distributed as dist

    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.parallel.collectives import all_reduce_mean_
    from splatformer_tpu_torch.parallel.distributed import (
        reduce_metric_sums, sync_processes)
    from splatformer_tpu_torch.parallel.mesh import make_mesh
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import (make_train_step,
                                                           trainable_grads)

    name = "dp_training_flash" if flash else "dp_training"
    tcfg = train_config()
    oc = tcfg.optimizer
    cfg = get_config()   # zeroinit and drop_path 0.3, as the recipe
    cfg.backbone.enable_flash = flash
    mesh = make_mesh()
    batch = make_request(410, SCENE_PAD, SCENE_N, VIEWS, HW, "cuda")
    runs = {}
    for way, m in (("plain", None), ("dp", mesh)):
        model = build_feature_predictor(
            cfg, device="cuda", seed=0, compute_dtype="bfloat16",
            bn_group=m.data_group if m else None)
        opt = build_optimizer(model, dict(oc.lr_dict), oc.type, oc.eps,
                              oc.schedule, tcfg.total_steps,
                              oc.warmup_steps, tcfg.grad_clip_norm)
        step = make_train_step(
            model, opt, image_l1_loss_weight=tcfg.image_l1_loss_weight,
            mesh=m)
        gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
        metrics, launches, det_ms, peak, warned = deterministic_step(
            step, batch, gen)
        runs[way] = {"metrics": metrics, "launches": launches,
                     "det_ms": det_ms, "peak_mem_gb": peak,
                     "warnings": warned, "model": model, "step": step,
                     "gen": gen, "ms": [],
                     "grads": [g.clone() for g in trainable_grads(model)],
                     "state": {k: v.clone()
                               for k, v in model.state_dict().items()}}
    # the step's time both ways, in turns, outside the deterministic mode
    for way in ("plain", "dp", "dp", "plain", "plain", "dp"):
        r = runs[way]
        r["ms"].append(timed_step(r["step"], batch, r["gen"]))
    d = runs["dp"]
    grads = trainable_grads(d["model"])
    d["grad_elements"] = sum(g.numel() for g in grads)
    d["allreduce_ms"] = cuda_ms(
        lambda: all_reduce_mean_(grads, mesh.data_group), 10)
    flat = torch.cat([g.reshape(-1) for g in grads])
    d["nccl_ms"] = cuda_ms(
        lambda: dist.all_reduce(flat, group=mesh.data_group), 10)
    del grads, flat
    for r in runs.values():
        del r["model"], r["step"], r["gen"]
    torch.cuda.empty_cache()
    p, d = runs["plain"], runs["dp"]
    grads_differing = sum(int((a != b).sum())
                          for a, b in zip(p["grads"], d["grads"]))
    state_differing = {k: int((v != d["state"][k]).sum())
                       for k, v in p["state"].items()}
    stats_differing = sum(v for k, v in state_differing.items()
                          if k.endswith((".mean", ".var")))
    reduced = reduce_metric_sums({"psnr": 61.0, "ssim": 1.5}, 2.0)
    sync_processes("chip_smoke")
    k3 = K3_BLOCKS if flash else 0
    expected = with_projection({"composite_fwd": 1, "composite_bwd": 1,
                                "attention_fwd": k3, "attention_bwd": k3})
    result = {
        "phase": name, "model": "ptv3_base", "compute_dtype": "bfloat16",
        "patch": 1024 if flash else 128,
        "backend": dist.get_backend(), "world_size": dist.get_world_size(),
        "loss": [p["metrics"]["total_loss"], d["metrics"]["total_loss"]],
        "metrics_equal": p["metrics"] == d["metrics"],
        "grads_differing": grads_differing,
        "params_differing": sum(state_differing.values()) - stats_differing,
        "bn_stats_differing": stats_differing,
        "grad_elements": d["grad_elements"],
        "grad_bytes": 4 * d["grad_elements"],
        "step_ms": {"plain": p["ms"], "dp": d["ms"]},
        "step_ms_median": {"plain": float(np.median(p["ms"])),
                           "dp": float(np.median(d["ms"]))},
        "step_ms_deterministic": {"plain": p["det_ms"], "dp": d["det_ms"]},
        "grad_allreduce_ms": d["allreduce_ms"],
        "grad_allreduce_nccl_call_ms": d["nccl_ms"],
        "peak_mem_gb": max(p["peak_mem_gb"], d["peak_mem_gb"]),
        "launches": {"plain": p["launches"], "dp": d["launches"]},
        "deterministic_mode_warnings": sorted(set(p["warnings"])
                                              | set(d["warnings"])),
        "reduce_metric_sums": reduced}
    emit(result)
    if not (result["metrics_equal"] and grads_differing == 0
            and sum(state_differing.values()) == 0):
        raise AssertionError(f"the DP step at world size 1 is not the plain "
                             f"step bit for bit: {result}")
    if p["launches"] != expected or d["launches"] != expected:
        raise AssertionError(f"{name} launched {result['launches']}, want "
                             f"{expected} a step")
    if reduced != {"psnr": 30.5, "ssim": 0.75}:
        raise AssertionError(f"reduce_metric_sums: {reduced}")
    return d["launches"]


def phase_gauss_shard():
    """render_images_gauss_sharded at full width (100k live Gaussians of
    100,352, 4 views at 256^2, background (0.1, 0.2, 0.3)) through the
    NCCL group (G = 1), LocalShards(2) and LocalShards(4), against the
    unsharded render_images_stats: rgb and alpha within 2e-5, the gradient
    of mean(rgb^2) by means, scales, quats, opacities and features_dc
    within 1e-5 + 5e-3 |g|, nothing dropped, K1 and K2 G times each per
    forward and backward; ms per forward and backward at each G and
    unsharded; the exchange's bytes per rank. Then K1 and K2 against
    their plain versions on the row blocks of LocalShards(4)'s busiest
    destination (K1_TOL and walks exact, K2_TOL). Returns the three
    sharded runs' launches summed."""
    import torch.distributed as dist

    from splatformer_tpu_torch.data.synthetic import (orbit_cameras,
                                                      random_scene)
    from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from splatformer_tpu_torch.ops.render import render_images_stats
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.parallel.gauss_shard import (
        GroupExchange, LocalShards, RowBlocks, merge_entries,
        render_images_gauss_sharded, send_shard, shard_scene)

    attrs = ("means", "scales", "quats", "opacities", "features_dc")
    scene = random_scene(np.random.default_rng(7), SCENE_PAD, sh_degree=1,
                         n_valid=SCENE_N, device="cuda")
    cams = orbit_cameras(VIEWS, HW, HW, device="cuda")
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    rcfg = RasterizeConfig()

    def run(render):
        leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                  for k in attrs}
        rgb, alpha = render(scene.replace(**leaves))
        torch.mean(torch.square(rgb)).backward()
        return rgb.detach(), alpha.detach(), {k: leaves[k].grad
                                              for k in attrs}

    def unsharded(s):
        return render_images_stats(s, cams, bg, rcfg)[:2]

    rgb0, alpha0, g0 = run(unsharded)
    with torch.no_grad():
        dropped0 = int(render_images_stats(scene, cams, bg,
                                           rcfg)[2]["num_dropped"])
    ref_ms = cuda_ms(lambda: run(unsharded), 3)
    rows, totals = [], dict.fromkeys(LAUNCHES, 0)
    for label, gauss in (("nccl_group", GroupExchange(dist.group.WORLD)),
                         ("local_shards_2", LocalShards(2)),
                         ("local_shards_4", LocalShards(4))):
        def sharded(s, gauss=gauss):
            return render_images_gauss_sharded(s, cams, bg, rcfg, gauss)
        torch.cuda.synchronize()
        reset_launches()
        rgb, alpha, g = run(sharded)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        for k in totals:
            totals[k] += launches[k]
        ms = cuda_ms(lambda: run(sharded), 3)
        n_shards = gauss.size
        geo = RowBlocks(HW, HW, rcfg.tile_size, n_shards)
        with torch.no_grad():
            dropped = [int(send_shard(shard_scene(scene, i,
                                                  SCENE_PAD // n_shards),
                                      cams, rcfg, geo,
                                      rcfg.max_intersects).dropped)
                       for i in range(n_shards)]
        grad_err = {k: float((g[k] - g0[k]).abs().max()) for k in attrs}
        grad_excess = {k: float(((g[k] - g0[k]).abs() - GAUSS_GRAD_ATOL
                                 - GAUSS_GRAD_RTOL * g0[k].abs()).max())
                       for k in attrs}
        rows.append({
            "exchange": label, "shards": n_shards,
            "rgb_max_abs_err": float((rgb - rgb0).abs().max()),
            "alpha_max_abs_err": float((alpha - alpha0).abs().max()),
            "grad_max_abs_err": grad_err, "grad_excess": grad_excess,
            "num_dropped": dropped, "ms": ms, "launches": launches,
            "exchange_bytes_per_rank": n_shards * rcfg.max_intersects
            * PAYLOAD_BYTES * VIEWS,
            "rows_per_block": geo.rows_loc})

    # the row blocks of one destination through K1 and K2 and their plain
    # versions: LocalShards(4)'s destination with the most entries
    geo = RowBlocks(HW, HW, rcfg.tile_size, 4)
    with torch.no_grad():
        sends = [send_shard(shard_scene(scene, i, SCENE_PAD // 4), cams,
                            rcfg, geo, rcfg.max_intersects)
                 for i in range(4)]
        received = LocalShards(4).exchange(sends)
        live = [int((k >> 32 < VIEWS * geo.tiles_loc).sum())
                for k, _ in received]
        dest = int(np.argmax(live))
        packed_t, tile_start = merge_entries(*received[dest], dest, VIEWS,
                                             geo)
    hold = hold_kernels(packed_t, tile_start, geo.tiles_x, geo.tiles_loc, 9)
    result = {"phase": "gauss_shard", "gaussians": SCENE_PAD,
              "live": SCENE_N, "views": VIEWS, "hw": HW,
              "unsharded_ms": ref_ms, "unsharded_num_dropped": dropped0,
              "runs": rows,
              "row_block_kernels": {"destination": dest,
                                    "entries": live[dest],
                                    "tiles": VIEWS * geo.tiles_loc, **hold}}
    emit(result)
    for r in rows:
        n_shards = r["shards"]
        if not (r["rgb_max_abs_err"] <= GAUSS_FWD_TOL
                and r["alpha_max_abs_err"] <= GAUSS_FWD_TOL
                and max(r["grad_excess"].values()) <= 0
                and sum(r["num_dropped"]) == 0 and dropped0 == 0):
            raise AssertionError(f"the sharded render at G = {n_shards} "
                                 f"disagrees: {r}")
        # the sharded render projects each view in plain PyTorch
        want = with_projection({"composite_fwd": n_shards,
                                "composite_bwd": n_shards,
                                "attention_fwd": 0, "attention_bwd": 0},
                               renders=0, backwards=0)
        if r["launches"] != want:
            raise AssertionError(f"G = {n_shards} launched {r['launches']}, "
                                 f"want {want}")
    if not (hold["k1_max_abs_err"] <= K1_TOL
            and hold["walked_mismatches"] == 0
            and max(hold["k2_row_rel_err"]) <= K2_TOL
            and hold["stray_nonzeros"] == 0 and live[dest] > 0):
        raise AssertionError(f"K1/K2 on the row blocks: {hold}")
    return totals


def phase_train2d():
    """The 2-D (data x gauss) step, PTv3-base at full width (bf16,
    drop_path 0.3, heads not zero-initialised but x0.01 so that the
    backbone gets gradients, Adam), each step from one state, generator
    seed and batch, under the deterministic mode: (data 1, gauss 1) over
    NCCL groups against the DP step, and (1, LocalShards(2)) against
    (1, 1): loss within 1e-6 relative, gradient cosine >= 0.99999 (the
    render bins view by view and sums the L1 row block by row block, so
    float32 sums may round in another order; at G = 1 they do not: the
    per-view binning keeps the flat binning's entries in its order, the
    row mask is all ones and the denominator the mean's count, so the
    (1, 1) step has so far matched the DP step bit for bit); launches,
    peak memory and the step's ms (3 steps a variant, in turns). Returns
    the 2-D steps' launches summed."""
    from splatformer_tpu_torch.configs.model_ptv3_base import get_config
    from splatformer_tpu_torch.configs.train_default import \
        get_config as train_config
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.parallel.gauss_shard import LocalShards
    from splatformer_tpu_torch.parallel.mesh import make_mesh
    from splatformer_tpu_torch.parallel.train2d import (make_mesh_2d,
                                                        make_train_step_2d)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import (make_train_step,
                                                           trainable_grads)

    tcfg = train_config()
    oc = tcfg.optimizer
    cfg = get_config()
    cfg.zeroinit = False
    mesh, mesh2 = make_mesh(), make_mesh_2d(1, 1)
    model = build_feature_predictor(cfg, device="cuda", seed=0,
                                    head_final_scale=0.01,
                                    compute_dtype="bfloat16",
                                    bn_group=mesh2.data_group)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_request(420, SCENE_PAD, SCENE_N, VIEWS, HW, "cuda")
    rcfg = RasterizeConfig()
    w = tcfg.image_l1_loss_weight
    variants = {
        "dp": lambda opt: make_train_step(model, opt, rcfg, w, mesh=mesh),
        "2d_1x1": lambda opt: make_train_step_2d(model, opt, mesh2, rcfg, w),
        "2d_1xlocal2": lambda opt: make_train_step_2d(
            model, opt, mesh2, rcfg, w, gauss=LocalShards(2))}
    runs = {}
    for name, make in variants.items():
        model.load_state_dict(init)
        opt = build_optimizer(model, dict(oc.lr_dict), oc.type, oc.eps,
                              oc.schedule, tcfg.total_steps,
                              oc.warmup_steps, tcfg.grad_clip_norm)
        step = make(opt)
        gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
        metrics, launches, det_ms, peak, warned = deterministic_step(
            step, batch, gen)
        grad = torch.cat([g.reshape(-1) for g in trainable_grads(model)])
        runs[name] = {"metrics": metrics, "launches": launches,
                      "det_ms": det_ms, "peak_mem_gb": peak,
                      "warnings": warned, "grad": grad.double(),
                      "step": step, "gen": gen, "ms": []}
    # each step's time, 3 steps a variant in turns, outside the
    # deterministic mode (the shared model moves on; each is a real step)
    for name in ("dp", "2d_1x1", "2d_1xlocal2", "2d_1xlocal2", "2d_1x1",
                 "dp", "dp", "2d_1x1", "2d_1xlocal2"):
        runs[name]["ms"].append(timed_step(runs[name]["step"], batch,
                                           runs[name]["gen"]))
    for r in runs.values():
        r["ms_median"] = float(np.median(r["ms"]))
        del r["step"], r["gen"]

    def compare(a, b):
        ga, gb = runs[a]["grad"], runs[b]["grad"]
        la = runs[a]["metrics"]["total_loss"]
        lb = runs[b]["metrics"]["total_loss"]
        return {"pair": [a, b], "loss": [la, lb],
                "loss_rel_diff": abs(la - lb) / abs(lb),
                "grad_cos": float(ga @ gb / (ga.norm() * gb.norm())),
                "grad_max_abs_diff": float((ga - gb).abs().max()),
                "grad_max_abs": float(gb.abs().max()),
                "bit_identical": bool(torch.equal(ga, gb)) and la == lb}

    pairs = [compare("2d_1x1", "dp"), compare("2d_1xlocal2", "2d_1x1")]
    result = {"phase": "train2d", "model": "ptv3_base",
              "compute_dtype": "bfloat16", "comparisons": pairs,
              **{name: {k: v for k, v in r.items() if k != "grad"}
                 for name, r in runs.items()}}
    emit(result)
    for c in pairs:
        if not (c["loss_rel_diff"] <= TRAIN2D_LOSS_RTOL
                and c["grad_cos"] >= TRAIN2D_GRAD_COS):
            raise AssertionError(f"train2d {c['pair']} disagree: {c}")
    for name, g in (("dp", 1), ("2d_1x1", 1), ("2d_1xlocal2", 2)):
        # the 2-D steps render Gaussian-sharded: no fused projection
        p1 = 1 if name == "dp" else 0
        want = with_projection({"composite_fwd": g, "composite_bwd": g,
                                "attention_fwd": 0, "attention_bwd": 0},
                               renders=p1, backwards=p1)
        if runs[name]["launches"] != want:
            raise AssertionError(f"train2d {name} launched "
                                 f"{runs[name]['launches']}, want {want}")
        if not (np.isfinite(runs[name]["metrics"]["total_loss"])
                and runs[name]["metrics"]["num_dropped"] == 0):
            raise AssertionError(f"train2d {name}: {runs[name]['metrics']}")
    totals = dict.fromkeys(runs["dp"]["launches"], 0)
    for name in ("2d_1x1", "2d_1xlocal2"):
        for k in totals:
            totals[k] += runs[name]["launches"][k]
    return totals


def phase_dryrun():
    """``python -m splatformer_tpu_torch.dryrun_multichip`` under
    ``torchrun --standalone --nproc_per_node=1`` in its own processes (its
    NCCL group of one): the DP step, the sharded render's value and
    gradient, the 2-D step with LocalShards(2), each finite."""
    out, seconds = run_module(
        "torch.distributed.run",
        ["--standalone", "--nproc_per_node=1", "-m",
         "splatformer_tpu_torch.dryrun_multichip"], timeout=300)
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun")]
    emit({"phase": "dryrun", "seconds": seconds, "lines": lines})
    if not (len(lines) == 3 and all(" ok" in ln for ln in lines)):
        raise AssertionError(f"dryrun_multichip printed: {out[-2000:]}")


def run_parallel_phases():
    """The four parallel phases in an NCCL group of one (destroyed before
    the dry run's own processes start); returns the launches of the DP,
    gauss_shard and train2d phases, summed."""
    import shutil

    import torch.distributed as dist
    tmp = init_world_of_one()
    try:
        totals = phase_dp_training()
        torch.cuda.empty_cache()
        for more in (phase_dp_training(flash=True), phase_gauss_shard(),
                     phase_train2d()):
            torch.cuda.empty_cache()
            for k in totals:
                totals[k] += more[k]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    phase_dryrun()
    return totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import splatformer_tpu_torch  # noqa: F401  (the port, from this checkout)
    t_start = time.perf_counter()

    resources = phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    projection = phase_projection()
    fps = phase_fps()
    k3 = phase_k3(resources)
    k3_bwd = phase_k3(resources, backward=True)
    phase_reference()
    phase_reference(flash=True)
    t_merge = time.perf_counter()
    phase_merge_reference()
    merge_seconds = time.perf_counter() - t_merge
    phase_serving()
    torch.cuda.empty_cache()
    serving_flash = phase_serving(flash=True)  # float32 K3-fwd's path
    torch.cuda.empty_cache()
    t_merge = time.perf_counter()
    merge_requests = [make_request(300 + i, SCENE_PAD, SCENE_N, VIEWS, HW,
                                   "cuda")
                      for i in range(1 + MERGE_REQUESTS)]
    merge_launches = phase_serving_merge(merge_requests)
    for totals in (phase_serving_merge(merge_requests, flash=True),
                   phase_training_merge(merge_requests)):
        for k in merge_launches:
            merge_launches[k] += totals[k]
    del merge_requests
    merge_seconds += time.perf_counter() - t_merge
    torch.cuda.empty_cache()
    t_diag = time.perf_counter()
    diag_launches = phase_diagnostics()
    for totals in (phase_diagnostics(flash=True), phase_flops(),
                   phase_viewer()):
        torch.cuda.empty_cache()
        for k in diag_launches:
            diag_launches[k] += totals[k]
    diag_seconds = time.perf_counter() - t_diag
    phase_train_reference()
    phase_train_reference_flash()
    torch.cuda.empty_cache()
    phase_train_repro()
    phase_training()
    torch.cuda.empty_cache()
    launches = phase_training(flash=True)  # the train step's flash path
    torch.cuda.empty_cache()
    f32_launches = phase_training(flash=True, f32=True)  # float32 K3-bwd's
    torch.cuda.empty_cache()
    loop_launches = phase_loop()  # the training entry point
    torch.cuda.empty_cache()
    t_parallel = time.perf_counter()
    parallel_launches = run_parallel_phases()
    parallel_seconds = time.perf_counter() - t_parallel
    torch.cuda.empty_cache()  # the factory's own process
    phase_fit_reference()
    phase_fit_kernels()
    fit_launches = phase_factory()  # the data factory and its loaders
    capture_launches = phase_jpeg()  # fit_3dgs on a JPEG capture
    torch.cuda.empty_cache()  # the bench's own process needs ~40 GB
    phase_bench()
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "merge_phases_seconds": merge_seconds,
          "diag_phases_seconds": diag_seconds,
          "parallel_phases_seconds": parallel_seconds})
    flash_src = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    emit({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "splatformer_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "splatformer_tpu/ops/pallas/raster.py:272",
        "launches": launches["composite_fwd"],
        "loop_launches": loop_launches["composite_fwd"],
        "fit_launches": fit_launches["composite_fwd"],
        "capture_launches": capture_launches["composite_fwd"],
        "merge_launches": merge_launches["composite_fwd"],
        "diag_launches": diag_launches["composite_fwd"],
        "parallel_launches": parallel_launches["composite_fwd"],
        "max_abs_err": max(k1["max_abs_err_rgb"], k1["max_abs_err_T"]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "splatformer_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "splatformer_tpu/ops/pallas/raster.py:367",
        "launches": launches["composite_bwd"],
        "loop_launches": loop_launches["composite_bwd"],
        "fit_launches": fit_launches["composite_bwd"],
        "capture_launches": capture_launches["composite_bwd"],
        "merge_launches": merge_launches["composite_bwd"],
        "diag_launches": diag_launches["composite_bwd"],
        "parallel_launches": parallel_launches["composite_bwd"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None},
        *({"name": f"projection_{d}", "route": "cuda",
           "source": f"splatformer_tpu_torch/csrc/projection_{d}.cu",
           "replaces": None,
           "launches": launches[f"projection_{d}"],
           "loop_launches": loop_launches[f"projection_{d}"],
           "fit_launches": fit_launches[f"projection_{d}"],
           "capture_launches": capture_launches[f"projection_{d}"],
           "merge_launches": merge_launches[f"projection_{d}"],
           "diag_launches": diag_launches[f"projection_{d}"],
           "parallel_launches": parallel_launches[f"projection_{d}"],
           "max_abs_err": None,
           "ms": {f"{r['views']}x{r['hw']}": r[f"{d}_ms"]
                  for r in projection},
           "plain_ms": {f"{r['views']}x{r['hw']}":
                        r["plain_ms" if d == "fwd" else "plain_bwd_ms"]
                        for r in projection},
           "bound_ms": {f"{r['views']}x{r['hw']}": r[f"{d}_bound_ms"]
                        for r in projection},
           "bound_by": "bytes", "library_ms": None}
          for d in ("fwd", "bwd")),
        {"name": "fps", "route": "cuda",
         "source": "splatformer_tpu_torch/csrc/fps.cu", "replaces": None,
         "launches": merge_launches["fps"], "phase_launches":
         fps["launches"]["fps"], "loop_launches": loop_launches["fps"],
         "fit_launches": fit_launches["fps"],
         "capture_launches": capture_launches["fps"],
         "diag_launches": diag_launches["fps"],
         "parallel_launches": parallel_launches["fps"],
         "max_abs_err": None, "ms": fps["ms"], "plain_ms": fps["plain_ms"],
         "bound_ms": fps["bound_ms"], "bound_by": "ops",
         "library_ms": None},
        k3_entry("attention_fwd",
                 "splatformer_tpu_torch/csrc/attention_fwd.cu",
                 f"{flash_src}:342 (called at "
                 "splatformer_tpu/models/ptv3.py:118)", launches, k3,
                 merge_launches, diag_launches, parallel_launches,
                 serving_flash, "serving_flash"),
        k3_entry("attention_bwd",
                 "splatformer_tpu_torch/csrc/attention_bwd.cu",
                 f"{flash_src}:796 and :1146 (called at "
                 "splatformer_tpu/models/ptv3.py:118)", launches, k3_bwd,
                 merge_launches, diag_launches, parallel_launches,
                 f32_launches, "training_flash_f32")]})
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
