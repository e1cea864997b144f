"""Multi-process dry run of the port's parallelism (port of
__graft_entry__.py:dryrun_multichip) at tiny shapes:

  1. one data-parallel train step over every process (gradient and metric
     mean, synced masked BatchNorm);
  2. a Gaussian-sharded render of one scene over every process, its value
     and its gradient through the exchange;
  3. one 2-D (data x gauss) train step: a (W / 2, 2) process mesh when the
     world W is even and at least 4, else (W, LocalShards(2)), the gauss
     group held inside each process.

    torchrun --nproc_per_node=2 -m splatformer_tpu_torch.dryrun_multichip --cpu
    torchrun --nproc_per_node=1 -m splatformer_tpu_torch.dryrun_multichip

Without torchrun it runs as a world of one process (no process group).
Runs on the card unless ``--cpu`` is given (gloo on the CPU, NCCL on the
card); each process prints one line a part and exits 1 on a non-finite
value.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

TINY_PTV3 = dict(
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(2, 2, 4),
    enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(2, 2), dec_patch_size=(16, 16), stride=(1, 2),
    drop_path=0.1, pool_capacity_factors=(1.0, 0.75))
N, VIEWS, HW = 256, 2, 32


def _model(device, bn_group):
    from splatformer_tpu_torch.models.feature_predictor import (
        FeaturePredictor, init_weights)
    model = FeaturePredictor(sh_degree=1, grid_resolution=64,
                             res_feature_activation={"means": "tanh"},
                             backbone_kwargs=TINY_PTV3, bn_group=bn_group)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device)


def _scene_batch(i: int, device):
    from splatformer_tpu_torch.data.synthetic import (orbit_cameras,
                                                      random_scene)
    from splatformer_tpu_torch.training.train_step import SceneBatch
    return SceneBatch(
        scene=random_scene(np.random.default_rng(i), N, device=device),
        cameras=orbit_cameras(VIEWS, HW, HW, device=device),
        images=torch.zeros((VIEWS, HW, HW, 3), device=device),
        background=torch.zeros(3, device=device))


def _finite(metrics) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(list(out.values()))):
        raise FloatingPointError(f"non-finite metrics: {out}")
    return out


def dryrun(device: torch.device) -> None:
    from splatformer_tpu_torch.data.synthetic import (orbit_cameras,
                                                      random_scene)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed)
    from splatformer_tpu_torch.parallel.gauss_shard import (
        LocalShards, render_images_gauss_sharded)
    from splatformer_tpu_torch.parallel.mesh import make_mesh
    from splatformer_tpu_torch.parallel.train2d import (make_mesh_2d,
                                                        make_train_step_2d)
    from splatformer_tpu_torch.training.optim import build_optimizer
    from splatformer_tpu_torch.training.train_step import make_train_step

    rank, world = maybe_initialize_distributed(device)
    rcfg = RasterizeConfig(max_intersects=2 ** 12, tiles_per_gauss=16)
    lr = {"base": 1e-4, "backbone": 3e-5}

    mesh = make_mesh()
    model = _model(device, mesh.data_group)
    step = make_train_step(model, build_optimizer(model, lr, total_steps=10),
                           rcfg, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(mesh.data_index)
    m = _finite(step(_scene_batch(rank, device), gen))
    print(f"dryrun_multichip({world}) rank {rank} DP train step ok: {m}",
          flush=True)

    scene = random_scene(np.random.default_rng(0), max(N, 2 * world),
                         device=device)
    means = scene.means.clone().requires_grad_(True)
    rgb, _ = render_images_gauss_sharded(
        scene.replace(means=means), orbit_cameras(1, HW, HW, device=device),
        torch.zeros(3, device=device), rcfg,
        mesh.data_group)   # every process in one gauss group
    loss = rgb.sum()
    loss.backward()
    if not (torch.isfinite(loss) and torch.isfinite(means.grad).all()):
        raise FloatingPointError("non-finite gauss-sharded render")
    print(f"dryrun_multichip({world}) rank {rank} gauss-sharded render ok: "
          f"loss={float(loss.detach()):.4f}", flush=True)

    if world >= 4 and world % 2 == 0:
        mesh2, gauss = make_mesh_2d(world // 2, 2), None
    else:
        mesh2, gauss = make_mesh_2d(world, 1), LocalShards(2)
    model2 = _model(device, mesh2.data_group)
    step2 = make_train_step_2d(
        model2, build_optimizer(model2, lr, total_steps=10), mesh2, rcfg,
        gauss=gauss)
    gen = torch.Generator(device=device).manual_seed(mesh2.data_index)
    m = _finite(step2(_scene_batch(mesh2.data_index, device), gen))
    print(f"dryrun_multichip({world}) rank {rank} 2-D ({mesh2.n_data}x"
          f"{gauss.size if gauss else mesh2.n_gauss}) data x gauss train "
          f"step ok: {m}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (gloo, the kernels' plain versions)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device is available (pass --cpu)",
              file=sys.stderr)
        return 1
    import torch.distributed as dist
    try:
        dryrun(torch.device("cpu" if args.cpu else "cuda"))
    except FloatingPointError as e:
        print(f"dryrun_multichip: {e}", file=sys.stderr)
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
