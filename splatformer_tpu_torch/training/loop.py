"""Training and evaluation orchestration (port of
splatformer_tpu/training/loop.py, the reference train.py's ``training()``
and ``evaluation()``): a host-side loop feeding the train step; periodic
evaluation over every test set with image grids, metric JSONs and eval.csv
rows; best-by-held-out-PSNR and periodic checkpoints; history.json and
config.json.

Data comes from the synthetic scenes or from scene folders
(data/dataset.py:SplatfactoScenes, written by the data factory), with a
host prefetch thread when ``num_workers`` > 0. One process on one device:
the loaders shard scenes by torch.distributed's rank and world size when
it is initialised, but the JAX package's cross-process metric reduction is
the plain per-image mean here, and file names keep its ``rank0``. There is
no TensorBoard: history.json and train.log carry the scalars. train.py
refuses ``--save_viewer`` (ROADMAP.md queue 1 item 5).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.models.feature_predictor import (
    FeaturePredictor, build_feature_predictor)
from splatformer_tpu_torch.models.lpips import make_lpips_fn
from splatformer_tpu_torch.ops.render import render_images
from splatformer_tpu_torch.ops.types import RasterizeConfig
from splatformer_tpu_torch.training import checkpoints as ckpt_lib
from splatformer_tpu_torch.training.checkpoints import TrainState
from splatformer_tpu_torch.training.metrics import MetricComputer
from splatformer_tpu_torch.training.optim import build_optimizer
from splatformer_tpu_torch.training.train_step import (SceneBatch,
                                                       make_eval_step,
                                                       make_train_step)
from splatformer_tpu_torch.utils.logging import (device_peak_memory_mb,
                                                 get_logger, make_grid,
                                                 save_image)

RUN_EVAL_CSV_HEADER = ("dataset,step,psnr,ssim,lpips,input_psnr,"
                       "input_ssim,input_lpips\n")


# ---------------------------------------------------------------------------
# data providers
# ---------------------------------------------------------------------------

def _pad_scene(scene, n_pad: int):
    """Append ``n_pad - n`` masked zero slots (the JAX scene loaders'
    ``pad_gaussians``)."""
    n = scene.num_points

    def pad(x):
        return torch.cat([x, x.new_zeros((n_pad - n,) + x.shape[1:])])
    return scene.replace(
        means=pad(scene.means), scales=pad(scene.scales),
        quats=pad(scene.quats), opacities=pad(scene.opacities),
        features_dc=pad(scene.features_dc),
        features_rest=pad(scene.features_rest), mask=pad(scene.mask))


def _synthetic_scene_pair(i: int, n: int, n_pad: int, hw: int, views: int,
                          rcfg: RasterizeConfig, background: torch.Tensor
                          ) -> SceneBatch:
    """(input scene, GT images): GT rendered from a clean scene, the input a
    perturbed copy, from the JAX package's numpy stream (seed 1000 + i),
    then padded to ``n_pad`` slots."""
    device = background.device
    rng = np.random.default_rng(1000 + i)
    clean = random_scene(rng, n, sh_degree=1, device=device)
    cams = orbit_cameras(views, hw, hw, device=device)
    with torch.no_grad():
        gt, _ = render_images(clean, cams, background, rcfg)

    def noise(scale):
        return scale * torch.as_tensor(rng.normal(size=(n, 3)),
                                       dtype=torch.float32).to(device)
    noisy = clean.replace(means=clean.means + noise(0.004),
                          scales=clean.scales + noise(0.1))
    return SceneBatch(scene=_pad_scene(noisy, n_pad), cameras=cams,
                      images=gt, background=background)


def make_synthetic_data(ds_cfg, rcfg: RasterizeConfig, device="cuda"):
    """Returns (train batch iterator, {name: test scene list factory}).

    The live Gaussians are the JAX package's at any ``pad_to``; scenes
    then hold ``max(pad_to, n_gaussians)`` slots, the rest masked zeros
    (the JAX package's scene loaders pad so; its synthetic scenes are not
    padded)."""
    device = resolve_device(device)
    background = torch.as_tensor(ds_cfg.background_color,
                                 dtype=torch.float32).to(device) / 255.0
    n_pad = max(ds_cfg.pad_to, ds_cfg.n_gaussians)
    pairs = [_synthetic_scene_pair(i, ds_cfg.n_gaussians, n_pad,
                                   ds_cfg.image_size, ds_cfg.image_per_scene,
                                   rcfg, background)
             for i in range(ds_cfg.n_scenes)]

    def train_iter():
        i = 0
        while True:
            yield pairs[i % len(pairs)]
            i += 1

    def test_scenes():
        return [(f"scene{i}", pairs[i]) for i in range(min(4, len(pairs)))]

    return train_iter(), {"synthetic": test_scenes}


def process_rank() -> Tuple[int, int]:
    """(index, count) of this process: torch.distributed's rank and world
    size when it is initialised, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_splatfacto_data(ds_cfg, device="cuda"):
    """Scene-folder data (nerfstudio checkpoints and COLMAP folders):
    (train batch iterator, {name: test scene list factory}), scenes padded
    to ``pad_to`` (0: ``max_gs_num`` rounded up to a multiple of 1024)."""
    from splatformer_tpu_torch.data.dataset import (SplatfactoScenes,
                                                    to_scene_batch)

    # one scene a micro-step (the reference's loader asserts batch %
    # (ngpus * accum) == 0 and its FeaturePredictor batch 1); a larger
    # batch is accumulate_step
    if ds_cfg.batch_size != 1:
        raise ValueError(f"batch_size {ds_cfg.batch_size}: scenes go one a "
                         "step; use dataset.accumulate_step")
    device = resolve_device(device)
    pad_to = ds_cfg.pad_to or ((ds_cfg.max_gs_num + 1023) // 1024) * 1024
    index, count = process_rank()
    train_ds = SplatfactoScenes(
        "train", ds_cfg.train.nerfstudio_folder, ds_cfg.train.colmap_folder,
        load_pose_src=ds_cfg.load_pose_src,
        sample_ratio_test=ds_cfg.train.sample_ratio_test,
        image_per_scene=ds_cfg.train.image_per_scene,
        remove_outlier_ndevs=ds_cfg.remove_outlier_ndevs,
        max_gs_num=ds_cfg.max_gs_num, pad_to=pad_to,
        background_color=ds_cfg.train.background_color,
        cache_steps=ds_cfg.train.cache_steps,
        cache_num_scenes=ds_cfg.train.cache_num_scenes,
        process_index=index, process_count=count,
        split_across_processes=ds_cfg.train.split_across_processes,
        augment=dict(ds_cfg.train.augment) or None)

    def train_iter():
        it = train_ds.iter_train()
        while True:
            yield to_scene_batch(next(it), device)

    def make_test_factory(folders):
        def factory():
            ds = SplatfactoScenes(
                "test", folders[0], folders[1],
                load_pose_src=ds_cfg.load_pose_src,
                remove_outlier_ndevs=ds_cfg.remove_outlier_ndevs,
                max_gs_num=ds_cfg.max_gs_num, pad_to=pad_to,
                background_color=list(ds_cfg.test.background_color),
                process_index=index, process_count=count,
                split_across_processes=ds_cfg.test.split_across_processes)
            # keyed by scene name, so metric JSONs join with the folders
            return [(str(sample["scene_name"]), to_scene_batch(sample, device))
                    for sample in ds.iter_test()]
        return factory

    test = {name: make_test_factory(folders)
            for name, folders in ds_cfg.test.folders.items()}
    return train_iter(), test


# ---------------------------------------------------------------------------
# evaluation (reference train.py:69-192)
# ---------------------------------------------------------------------------

def calibrate_from_data(first_batch: SceneBatch, test_factories, rcfg,
                        logger=None, extra_batches=()) -> RasterizeConfig:
    """Size the binning budgets from the data: the first training batches'
    scenes plus every scene of the first test set (ops/calibrate.py), so
    num_dropped stays 0 for the run."""
    from splatformer_tpu_torch.ops.calibrate import (calibrate_raster_config,
                                                     calibration_summary)
    samples = [(b.scene, b.cameras)
               for b in (first_batch,) + tuple(extra_batches)]
    try:
        first_factory = next(iter(test_factories.values()), None)
        if first_factory is not None:
            for _, sb in (first_factory() if callable(first_factory)
                          else first_factory):
                samples.append((sb.scene, sb.cameras))
    except Exception as e:  # calibration must never kill a run
        if logger:
            logger.warning("test-set calibration sampling failed: %s", e)
    out = calibrate_raster_config(samples, rcfg)
    if logger:
        logger.info("calibrated raster budgets from %d samples: %s",
                    len(samples), calibration_summary(out))
    return out


def _to_u8(img: torch.Tensor) -> np.ndarray:
    return (np.clip(img.detach().cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def evaluation(model: FeaturePredictor, scene_list, rcfg: RasterizeConfig,
               output_dir: str, output_gt: bool = False,
               compare_with_input: bool = False, save_as_single: bool = False,
               lpips_fn=None) -> Tuple[Dict[str, float], Dict[str, float],
                                       float]:
    """Evaluate a list of (name, SceneBatch) scenes.

    Returns (metrics, metrics_input, peak_mem_mb); metrics are per-image
    means over the list."""
    os.makedirs(output_dir, exist_ok=True)
    mc = MetricComputer(lpips_fn)
    mc_input = MetricComputer(lpips_fn) if compare_with_input else None
    ev = make_eval_step(model, rcfg)
    ev_input = (make_eval_step(None, rcfg, render_input=True)
                if compare_with_input else None)

    for name, batch in scene_list:
        pred, _, _, _, n_drop = ev(batch)
        if int(n_drop) > 0:
            get_logger().warning(
                "scene %s: binning dropped %d (gaussian, tile) entries — "
                "raise RasterizeConfig.max_intersects/tiers", name,
                int(n_drop))
        mc.update(pred, batch.images, name=name)

        pred_u8, gt_u8 = _to_u8(pred), _to_u8(batch.images)
        save_image(os.path.join(output_dir, f"{name}_pred.png"),
                   make_grid(list(pred_u8)))
        if output_gt:
            save_image(os.path.join(output_dir, f"{name}_gt.png"),
                       make_grid(list(gt_u8)))
        if compare_with_input:
            in_pred = ev_input(batch)[0]
            mc_input.update(in_pred, batch.images, name=name)
            in_u8 = _to_u8(in_pred)
            cmp_dir = os.path.join(output_dir, "compare", str(name))
            for vi in range(pred_u8.shape[0]):
                strip = np.concatenate([gt_u8[vi], in_u8[vi], pred_u8[vi]],
                                       axis=1)
                save_image(os.path.join(cmp_dir, f"{vi:02d}.png"), strip)
        if save_as_single:
            sdir = os.path.join(output_dir, "pred", str(name))
            for vi in range(pred_u8.shape[0]):
                save_image(os.path.join(sdir, f"{vi:02d}.png"), pred_u8[vi])

    mc.write_to_file(os.path.join(output_dir, "metrics.rank0.json"))
    n_images = float(sum(arr.size for arr in
                         next(iter(mc.results.values()), [])))

    def means(sums):
        return {k: v / max(n_images, 1.0) for k, v in sums.items()}
    metrics = means(mc.sum())
    metrics_input = {}
    if compare_with_input:
        mc_input.write_to_file(os.path.join(output_dir,
                                            "metrics_input.rank0.json"))
        metrics_input = means(mc_input.sum())
    return (metrics, metrics_input,
            device_peak_memory_mb(next(model.parameters()).device))


# ---------------------------------------------------------------------------
# training (reference train.py:195-353)
# ---------------------------------------------------------------------------

def build_train_state(cfg, model: FeaturePredictor, device) -> TrainState:
    """The optimizer of the config over ``model``, and the run's generator,
    at step 0."""
    oc = cfg.train.optimizer
    optimizer = build_optimizer(
        model, lr_dict=dict(oc.lr_dict), optimizer_type=oc.type, eps=oc.eps,
        schedule=oc.schedule, total_steps=cfg.train.total_steps,
        warmup_steps=oc.warmup_steps, grad_clip_norm=cfg.train.grad_clip_norm,
        accumulate_steps=cfg.dataset.accumulate_step,
        finetune_filter=tuple(oc.finetune_filter) or None)
    generator = torch.Generator(device=device).manual_seed(
        cfg.train.seed + 1)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def run_training(cfg, output_dir: str, max_steps: Optional[int] = None,
                 device="cuda"):
    """Train ``cfg`` into ``output_dir``, resuming from its newest
    checkpoint when there is one. Returns (state, model, test_factories,
    rcfg, lpips_fn)."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    logger = get_logger(os.path.join(output_dir, "train.log"))
    rcfg = RasterizeConfig()

    model = build_feature_predictor(
        cfg.model, device=device, seed=cfg.train.seed,
        compute_dtype="bfloat16" if cfg.train.bf16 else None)
    if getattr(cfg.dataset, "synthetic", False):
        train_iter, test_factories = make_synthetic_data(cfg.dataset, rcfg,
                                                         device)
    else:
        train_iter, test_factories = make_splatfacto_data(cfg.dataset,
                                                          device)
    first = next(train_iter)
    if cfg.train.auto_raster_budget:
        # two more (augmented) batches, so the measured tile statistics see
        # the corruption floaters that training renders
        extra = [next(train_iter) for _ in range(2)]
        rcfg = calibrate_from_data(first, test_factories, rcfg, logger,
                                   extra_batches=extra)
    state = build_train_state(cfg, model, device)
    if cfg.dataset.num_workers > 0:
        # host prefetch (the reference DataLoader's num_workers): scene
        # loading and decoding overlap the device step
        from splatformer_tpu_torch.data.dataset import prefetch_iterator
        train_iter = prefetch_iterator(train_iter,
                                       depth=cfg.dataset.num_workers)

    ckpt_dir = os.path.join(output_dir, "checkpoints")
    if ckpt_lib.latest_step(ckpt_dir) is not None:
        state = ckpt_lib.restore_checkpoint(ckpt_dir, state)
        logger.info("restored checkpoint at step %d", state.step)
    elif cfg.model.resume_ckpt:
        # pretrained-backbone partial load (shape-tolerant, reference
        # models/pointtransformer_v3.py:164-178)
        params, report = ckpt_lib.load_partial_params(
            cfg.model.resume_ckpt,
            {k: p.detach() for k, p in model.named_parameters()},
            scope="backbone")
        model.load_state_dict(params, strict=False)
        logger.info(
            "partial backbone load from %s: %d loaded, %d missing, "
            "%d shape-mismatched (kept fresh init)", cfg.model.resume_ckpt,
            len(report["loaded"]), len(report["missing"]),
            len(report["mismatched"]))
        for path in report["missing"] + report["mismatched"]:
            logger.info("  not loaded: %s", path)
    if (ckpt_lib.latest_step(ckpt_dir) is None
            and cfg.train.resume_from_step > 0):
        # reference train.py:209,227: offset the step counter when resuming
        # from weights without optimizer state
        state.step = int(cfg.train.resume_from_step)
        logger.info("resume_from_step: step counter set to %d", state.step)

    lpips_fn = make_lpips_fn(cfg.train.lpips_weights_path, device)
    lpips_w = cfg.train.lpips_loss_weight if lpips_fn is not None else 0.0
    if cfg.train.lpips_loss_weight > 0 and lpips_fn is None:
        logger.warning("LPIPS weights not found at %s — training with L1 only",
                       cfg.train.lpips_weights_path)

    step_fn = make_train_step(
        model, state.optimizer, rcfg,
        image_l1_loss_weight=cfg.train.image_l1_loss_weight,
        lpips_loss_weight=lpips_w, lpips=lpips_fn)
    pretrain_steps = cfg.train.pretrain_steps
    pretrain_fn = (make_train_step(model, state.optimizer, rcfg,
                                   pretrain=True)
                   if pretrain_steps > 0 else None)

    with open(os.path.join(output_dir, "config.json"), "w") as f:
        f.write(cfg.to_json(indent=2))

    total = max_steps if max_steps is not None else cfg.train.total_steps
    accum = cfg.dataset.accumulate_step
    log_image_interval = cfg.train.log_image_interval
    t_last, step_last = time.time(), state.step  # windowed-rate anchors
    batch = first
    history: List[dict] = []
    best = {"step": -1, "psnr": -float("inf")}
    best_path = os.path.join(output_dir, "best.json")
    resume_step = state.step
    if os.path.exists(best_path) and resume_step > 0:
        # trust best.json only when resuming: a fresh run reusing the
        # directory must not inherit the previous run's best PSNR
        with open(best_path) as f:
            best = json.load(f)
    _dedupe_eval_csv(os.path.join(output_dir, "eval.csv"), resume_step)
    for step in range(state.step, total * accum):
        opt_step = step // accum
        fn = pretrain_fn if (pretrain_fn is not None
                             and opt_step < pretrain_steps) else step_fn
        metrics = fn(batch, state.generator)
        state.step += 1
        if (log_image_interval and step % accum == 0
                and opt_step % log_image_interval == 0):
            # periodic train-scene render (reference train.py:317-325)
            pred = make_eval_step(model, rcfg)(batch)[0]
            save_image(os.path.join(output_dir, "train",
                                    f"{opt_step:08d}_pred-rank0.png"),
                       make_grid(list(_to_u8(pred))))
        if opt_step % cfg.train.log_interval == 0 and step % accum == 0:
            m = {k: float(v) for k, v in metrics.items()}
            # windowed rate since the last log line: excludes eval and save
            # pauses outside the window
            now = time.time()
            m["steps_per_s"] = ((step + 1 - step_last) / (now - t_last)
                                if now > t_last else 0.0)
            t_last, step_last = now, step + 1
            history.append({"step": opt_step, **m})
            logger.info("step %d: %s", opt_step,
                        " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if (step % accum == 0 and cfg.train.eval_interval > 0
                and opt_step > 0 and opt_step % cfg.train.eval_interval == 0):
            # flush history at every eval so interrupted runs keep it
            with open(os.path.join(output_dir, "history.json"), "w") as f:
                json.dump(history, f)
            results = _run_evals(model, test_factories, rcfg, output_dir,
                                 opt_step, logger, lpips_fn)
            # best-checkpoint tracking on the first test set's PSNR
            first_set = next(iter(results.values()), None)
            held_psnr = first_set[0].get("psnr") if first_set else None
            if held_psnr is not None and held_psnr > best["psnr"]:
                best = {"step": opt_step, "psnr": float(held_psnr)}
                ckpt_lib.save_checkpoint(
                    os.path.join(output_dir, "checkpoints_best"), state,
                    opt_step)
                with open(best_path, "w") as f:
                    json.dump(best, f)
                logger.info("new best held-out psnr %.4f at step %d",
                            best["psnr"], opt_step)
            t_last, step_last = time.time(), step + 1  # clean window
        if step % accum == 0 and (opt_step + 1) % cfg.train.save_interval == 0:
            ckpt_lib.save_checkpoint(ckpt_dir, state, opt_step)
            logger.info("saved checkpoint at step %d", opt_step)
            t_last, step_last = time.time(), step + 1
        batch = next(train_iter)

    if ckpt_lib.latest_step(ckpt_dir) != total:
        ckpt_lib.save_checkpoint(ckpt_dir, state, total)
    if history or not os.path.exists(os.path.join(output_dir, "history.json")):
        with open(os.path.join(output_dir, "history.json"), "w") as f:
            json.dump(history, f)
    return state, model, test_factories, rcfg, lpips_fn


def _dedupe_eval_csv(csv_path: str, resume_step: int):
    """Truncate a stale run-local eval.csv on training start: keep only rows
    with step <= the resumed step, so re-runs and resumes never leave
    duplicate or foreign rows."""
    if not os.path.exists(csv_path):
        return
    with open(csv_path) as f:
        lines = f.readlines()
    if not lines:
        return
    kept = [lines[0]]
    for line in lines[1:]:
        parts = line.split(",")
        try:
            step = int(parts[1])
        except (IndexError, ValueError):
            continue
        if step <= resume_step:
            kept.append(line)
    if len(kept) != len(lines):
        with open(csv_path, "w") as f:
            f.writelines(kept)


def _run_evals(model, test_factories, rcfg, output_dir, opt_step, logger,
               lpips_fn):
    """Periodic eval over every test set; always scores the input scenes
    beside the refined ones and appends a run-local eval.csv row
    (reference protocol: step-0 input eval + final compare,
    train.py:97-98,327-334)."""
    results = {}
    csv_path = os.path.join(output_dir, "eval.csv")
    for name, factory in test_factories.items():
        scenes = factory() if callable(factory) else factory
        metrics, metrics_in, max_mem = evaluation(
            model, scenes, rcfg,
            output_dir=os.path.join(output_dir, "eval", name, str(opt_step)),
            output_gt=(opt_step == 0), compare_with_input=True,
            lpips_fn=lpips_fn)
        logger.info("eval %s step %d: %s | input: %s (peak %.0f MB)",
                    name, opt_step,
                    " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                    " ".join(f"{k}={v:.4f}" for k, v in metrics_in.items()),
                    max_mem)
        results[name] = (metrics, metrics_in)
        new = not os.path.exists(csv_path)
        with open(csv_path, "a") as f:
            if new:
                f.write(RUN_EVAL_CSV_HEADER)
            f.write(",".join([name, str(opt_step)] + [
                f"{d.get(k, float('nan')):.6f}"
                for d in (metrics, metrics_in)
                for k in ("psnr", "ssim", "lpips")]) + "\n")
    return results
