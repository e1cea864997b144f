"""The port's scene data parallelism (parallel/, training/train_step.py's
``mesh``) in 2 gloo processes on the CPU, against the JAX package on its
2-device mesh (tests/conftest.py's virtual devices): masked BatchNorm with
cross-process statistics (unequal valid counts) against
``MaskedBatchNorm(axis_name)`` under shard_map, the data-parallel SGD step
against ``make_train_step``, and ``reduce_metric_sums`` against the JAX
package's semantics. Each tolerance is stated where it is used.

The processes are spawned (``run_gloo``, which tests/test_torch_gauss_shard.py
and tests/test_torch_train2d.py import too): each joins a gloo group through
a file store under ``tmp_path``, so parallel test workers never share a port,
and writes npz files that the parent compares. JAX is imported inside the
tests only, so the spawned processes never load it; every spawn has its own
join timeout, after which its processes are killed and the test fails."""
import datetime
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

JOIN_TIMEOUT = 60.0   # seconds, for one spawn's processes together
ORDER_PERM = (2, 0, 3, 1)
# tests/test_train_step.py's TINY model and RCFG
TINY = dict(enc_depths=(1, 1), enc_channels=(16, 32), enc_num_head=(2, 4),
            enc_patch_size=(16, 16), dec_depths=(1,), dec_channels=(16,),
            dec_num_head=(2,), dec_patch_size=(16,), stride=(2,),
            drop_path=0.0, pool_capacity_factors=(0.75,))
MODEL_KW = dict(sh_degree=1, grid_resolution=64,
                res_feature_activation={"means": "tanh"},
                backbone_kwargs=TINY)
RASTER = dict(max_intersects=2 ** 12, tiles_per_gauss=16)
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
                "features_rest", "mask")
N_PTS, VIEWS, HW = 128, 2, 32
N_VALID = (120, 97)         # unequal valid counts on the two processes
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU runs
    (tests/test_torch_checkpoint_metrics.py); the spawned processes take
    one each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bootstrap(fn, rank, world, out, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT))
    try:
        fn(rank, world, out, *args)
    except BaseException:
        with open(os.path.join(out, f"error.rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_gloo(fn, world, out, *args, timeout=JOIN_TIMEOUT):
    """Run ``fn(rank, world, out, *args)`` in ``world`` spawned processes of
    one gloo group; fail with their tracebacks if one fails, or kill them
    all and fail if they are not done within ``timeout`` seconds."""
    out = str(out)
    os.makedirs(out, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_bootstrap, args=(fn, r, world, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(
        out)) if f.startswith("error.")]
    assert not hung, f"ranks {hung} still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs) and not errors, (
        [p.exitcode for p in procs], errors)


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def scene_arrays(i, n_valid):
    """Scene i as numpy arrays (the port's copy of the JAX package's
    random_scene on one numpy stream), 2 views of uniform ground truth."""
    from splatformer_tpu_torch.data.synthetic import random_scene
    rng = np.random.default_rng(i)
    scene = random_scene(rng, N_PTS, 1, n_valid, device="cpu")
    out = {k: n(getattr(scene, k)) for k in SCENE_FIELDS}
    out["images"] = rng.uniform(size=(VIEWS, HW, HW, 3)).astype(np.float32)
    return out


def port_batch(arrays):
    from splatformer_tpu_torch.data.synthetic import orbit_cameras
    from splatformer_tpu_torch.ops.types import GaussianScene
    from splatformer_tpu_torch.training.train_step import SceneBatch
    return SceneBatch(
        scene=GaussianScene(**{k: torch.tensor(arrays[k])
                               for k in SCENE_FIELDS}),
        cameras=orbit_cameras(VIEWS, HW, HW, device="cpu"),
        images=torch.tensor(arrays["images"]), background=torch.zeros(3))


def jax_batch(scenes):
    """The JAX package's SceneBatch of the given scenes, stacked on a
    leading device axis."""
    import jax
    import jax.numpy as jnp
    from splatformer_tpu.data.synthetic import orbit_cameras
    from splatformer_tpu.ops.types import GaussianScene
    from splatformer_tpu.training.train_step import SceneBatch
    one = [SceneBatch(
        scene=GaussianScene(**{k: jnp.asarray(a[k]) for k in SCENE_FIELDS}),
        cameras=orbit_cameras(VIEWS, HW, HW), images=jnp.asarray(a["images"]),
        background=jnp.zeros(3)) for a in scenes]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *one)


def jax_initial_variables():
    """The JAX TINY model's variables (zeroinit off, so that the backbone
    gets gradients), as host arrays."""
    import jax
    from splatformer_tpu.models.feature_predictor import FeaturePredictor
    model = FeaturePredictor(backbone_type="PT", zeroinit=False,
                             bn_axis_name="data", **MODEL_KW)
    scene = jax.tree.map(lambda a: a[0], jax_batch(
        [scene_arrays(0, N_VALID[0])]).scene)
    return model, jax.device_get(jax.jit(
        lambda k, s: model.init(k, s, False))(jax.random.key(3), scene))


def jax_sgd(params):
    from splatformer_tpu.training import optim as joptim
    return joptim.build_optimizer(
        params, lr_dict={"base": LR, "backbone": LR}, grad_clip_norm=2.0,
        optimizer_type="sgd")


def port_sgd(model):
    from splatformer_tpu_torch.training.optim import build_optimizer
    return build_optimizer(model, {"base": LR, "backbone": LR},
                           optimizer_type="sgd", grad_clip_norm=2.0)


# ---------------------------------------------------------------------------
# the processes' work
# ---------------------------------------------------------------------------

BN_C = 6


def _bn_inputs():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 40, BN_C)) * 3 + 1).astype(np.float32)
    mask = np.zeros((2, 40), bool)
    mask[0, :31] = True
    mask[1, :9] = True
    w = rng.normal(size=(2, 40, BN_C)).astype(np.float32)
    return x, mask, w


def _bn_and_metrics_worker(rank, world, out):
    from splatformer_tpu_torch.models.layers import MaskedBatchNorm
    from splatformer_tpu_torch.parallel.distributed import reduce_metric_sums
    x, mask, w = _bn_inputs()
    bn = MaskedBatchNorm(BN_C, group=dist.group.WORLD).train()
    xt = torch.tensor(x[rank], requires_grad=True)
    y = bn(xt, torch.tensor(mask[rank]))
    (y * torch.tensor(w[rank])).sum().backward()
    sums = {"psnr": 30.0 + rank, "ssim": 0.5 * rank, "lpips": 0.25}
    red = reduce_metric_sums(sums, float(3 + 2 * rank))
    np.savez(os.path.join(out, f"bn.rank{rank}.npz"), y=n(y), dx=n(xt.grad),
             mean=n(bn.mean), var=n(bn.var),
             metrics=np.asarray([red[k] for k in sorted(red)]))


def _dp_step_worker(rank, world, out):
    from splatformer_tpu_torch.models.feature_predictor import (
        FeaturePredictor)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from splatformer_tpu_torch.training.train_step import make_train_step
    mesh = make_mesh(n_devices=world)
    model = FeaturePredictor(**MODEL_KW, bn_group=mesh.data_group)
    model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
    batch = shard_batch(mesh, [port_batch(dict(np.load(os.path.join(
        out, f"scene{i}.npz")))) for i in range(world)])
    step = make_train_step(model, port_sgd(model), RasterizeConfig(**RASTER),
                           mesh=mesh)
    m = step(batch, order_perm=torch.tensor(ORDER_PERM))
    sd = model.state_dict()
    np.savez(os.path.join(out, f"dp.rank{rank}.npz"),
             **{f"metric/{k}": n(v) for k, v in m.items()},
             **{f"sd/{k}": n(v) for k, v in sd.items()})


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_synced_bn_and_metric_sums_match_jax(tmp_path):
    """Two processes of 31 and 9 valid points: each process's output and
    input gradient, and the running statistics, against the JAX module
    under shard_map on 2 devices within 1e-5 (float32 statistics summed in
    another order); the running statistics are equal on both processes.
    reduce_metric_sums: the summed totals over the summed image counts,
    the JAX package's semantics (its reduction of the same sums in one
    process), within 1e-12."""
    run_gloo(_bn_and_metrics_worker, 2, tmp_path)

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from splatformer_tpu.models.layers import MaskedBatchNorm
    from splatformer_tpu.parallel.distributed import reduce_metric_sums

    x, mask, w = _bn_inputs()
    bn = MaskedBatchNorm(axis_name="data")
    variables = bn.init(jax.random.key(0), x[0], mask[0], False)

    def per_device(xs, ms, ws):
        def loss(xl):
            y, mut = bn.apply(variables, xl, ms[0], True,
                              mutable=["batch_stats"])
            return jnp.sum(y * ws[0]), (y, mut["batch_stats"])
        (_, (y, stats)), dx = jax.value_and_grad(loss, has_aux=True)(xs[0])
        return y[None], dx[None], stats["mean"][None], stats["var"][None]

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    y, dx, mean, var = jax.jit(jax.shard_map(
        per_device, mesh=mesh, in_specs=(P("data"),) * 3,
        out_specs=(P("data"),) * 4, check_vma=False))(x, mask, w)
    jsums = reduce_metric_sums({"psnr": 61.0, "ssim": 0.5, "lpips": 0.5},
                               8.0)
    for r in range(2):
        got = np.load(tmp_path / f"bn.rank{r}.npz")
        np.testing.assert_allclose(got["y"], np.asarray(y[r]), atol=1e-5)
        np.testing.assert_allclose(got["dx"], np.asarray(dx[r]), atol=1e-5)
        np.testing.assert_allclose(got["mean"], np.asarray(mean[r]),
                                   atol=1e-5)
        np.testing.assert_allclose(got["var"], np.asarray(var[r]),
                                   atol=1e-5)
        np.testing.assert_allclose(
            got["metrics"], [jsums[k] for k in sorted(jsums)], rtol=1e-12)
    a, b = (np.load(tmp_path / f"bn.rank{r}.npz") for r in range(2))
    assert np.array_equal(a["mean"], b["mean"])
    # the update is the group's, not the first process's own (running
    # mean 0 before it, momentum 0.01)
    assert not np.allclose(a["mean"], 0.01 * x[0][mask[0]].mean(0),
                           atol=1e-4)


def test_dp_step_matches_jax_two_devices(tmp_path, monkeypatch):
    """One SGD step (lr 0.05 after the 2.0 global-norm clip) of the TINY
    model on 2 scenes with 120 and 97 valid Gaussians, 2 gloo processes
    against the JAX package's make_train_step on a 2-device mesh (synced
    BatchNorm, gradient and metric pmean), from the same converted weights
    and the same order shuffle: each process's metrics (the means over the
    processes) within 1e-4 relative of JAX's; every parameter's update
    within 1e-3 of that tensor's largest update plus 2e-4 of the model's
    largest (tests/test_torch_train_step.py's bound); the BatchNorm running
    statistics within 1e-5; parameters and statistics bit-identical on the
    two processes."""
    import jax
    import jax.numpy as jnp
    from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig
    from splatformer_tpu.parallel.mesh import make_mesh
    from splatformer_tpu.training import train_step as jts
    from splatformer_tpu_torch.data.convert import state_dict_from_flax

    scenes = [scene_arrays(i, N_VALID[i]) for i in range(2)]
    for i, a in enumerate(scenes):
        np.savez(tmp_path / f"scene{i}.npz", **a)
    jmodel, variables = jax_initial_variables()
    init = state_dict_from_flax(variables["params"], variables["batch_stats"])
    torch.save(init, tmp_path / "init.pt")
    run_gloo(_dp_step_worker, 2, tmp_path)

    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(ORDER_PERM,
                                                            jnp.int32))
    tx = jax_sgd(variables["params"])
    mesh = make_mesh(n_devices=2)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    step = jts.make_train_step(jmodel, tx, mesh,
                               JaxConfig(max_per_tile=256, chunk_size=32,
                                         **RASTER))
    state, jm = step(state, jax_batch(scenes), jax.random.key(0))
    ref = state_dict_from_flax(jax.device_get(state.params),
                               jax.device_get(state.batch_stats))
    got = [dict(np.load(tmp_path / f"dp.rank{r}.npz")) for r in range(2)]
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k
    for k, v in jax.device_get(jm).items():
        np.testing.assert_allclose(got[0][f"metric/{k}"], np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    deltas = {k: (got[0][f"sd/{k}"] - n(init[k]), n(v) - n(init[k]))
              for k, v in ref.items()}
    gmax = max(float(np.abs(dj).max()) for _, dj in deltas.values())
    assert gmax > 0
    for k, (dt, dj) in deltas.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[0][f"sd/{k}"], n(ref[k]),
                                       atol=1e-5, err_msg=k)
            continue
        err = float(np.abs(dt - dj).max())
        assert err <= 1e-3 * float(np.abs(dj).max()) + 2e-4 * gmax, k
