"""The port's 2-D (data x gauss) train step (parallel/train2d.py) on the
CPU: 2 gloo processes (data), each holding a gauss group of 4 shards
(``LocalShards(4)``), against the JAX package's ``make_train_step_2d`` on a
(2, 4) mesh of its 8 virtual devices (tests/test_train2d.py's setting,
with SGD and a model whose heads are not zero so that the backbone gets
gradients); and a (2, 2) mesh of 4 processes, whose gauss exchange is an
AllToAll over gloo, against 2 processes with ``LocalShards(2)``. JAX is
imported inside the tests only (the spawned processes never load it)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel_dp import (MODEL_KW, N_VALID, ORDER_PERM,  # noqa: E402
                                    RASTER, jax_batch, jax_initial_variables,
                                    jax_sgd, n, port_batch, port_sgd,
                                    run_gloo, scene_arrays)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    k = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(k)


def _step_2d(out, data, mesh, gauss, tag):
    """One 2-D SGD step from the initial weights saved in ``data`` on this
    process's scene; its metrics and state_dict saved under ``tag``."""
    from splatformer_tpu_torch.models.feature_predictor import (
        FeaturePredictor)
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.parallel.train2d import (make_train_step_2d,
                                                        shard_batch_2d)
    model = FeaturePredictor(**MODEL_KW, bn_group=mesh.data_group)
    model.load_state_dict(torch.load(os.path.join(data, "init.pt")))
    batch = shard_batch_2d(mesh, [port_batch(dict(np.load(os.path.join(
        data, f"scene{i}.npz")))) for i in range(mesh.n_data)])
    step = make_train_step_2d(model, port_sgd(model), mesh,
                              RasterizeConfig(**RASTER), gauss=gauss)
    m = step(batch, order_perm=torch.tensor(ORDER_PERM))
    rank = torch.distributed.get_rank()
    np.savez(os.path.join(out, f"{tag}.rank{rank}.npz"),
             **{f"metric/{k}": n(v) for k, v in m.items()},
             **{f"sd/{k}": n(v) for k, v in model.state_dict().items()})


def _local_shards_worker(rank, world, out, data):
    from splatformer_tpu_torch.parallel.gauss_shard import LocalShards
    from splatformer_tpu_torch.parallel.train2d import make_mesh_2d
    mesh = make_mesh_2d(world, 1)
    for g in (4, 2):
        _step_2d(out, data, mesh, LocalShards(g), f"local{g}")


def _process_gauss_worker(rank, world, out, data):
    from splatformer_tpu_torch.parallel.train2d import make_mesh_2d
    _step_2d(out, data, make_mesh_2d(2, 2), None, "procs")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The initial weights (the JAX TINY model's, converted), the two
    scenes, and the port's runs: 2 processes x LocalShards(4) and (2)
    (one spawn), then the (2, 2) process mesh (another)."""
    from splatformer_tpu_torch.data.convert import state_dict_from_flax
    out = tmp_path_factory.mktemp("train2d")
    scenes = [scene_arrays(i, N_VALID[i]) for i in range(2)]
    for i, a in enumerate(scenes):
        np.savez(out / f"scene{i}.npz", **a)
    jmodel, variables = jax_initial_variables()
    init = state_dict_from_flax(variables["params"], variables["batch_stats"])
    torch.save(init, out / "init.pt")
    run_gloo(_local_shards_worker, 2, out / "local", str(out))
    run_gloo(_process_gauss_worker, 4, out / "procs", str(out))
    return out, scenes, jmodel, variables, init


def _load(out, tag, ranks):
    return [dict(np.load(out / f"{tag}.rank{r}.npz")) for r in ranks]


def test_2d_step_local_shards_matches_jax(runs, monkeypatch):
    """(2 data processes) x LocalShards(4) against make_train_step_2d at
    (2, 4): the metrics (L1 reassembled from the row blocks, num_dropped
    0) within 1e-4 relative; every parameter's update within 1e-3 of that
    tensor's largest update plus 2e-4 of the model's largest
    (tests/test_torch_train_step.py's bound); the BatchNorm statistics
    within 1e-5; the two processes' states bit-identical."""
    import jax
    import jax.numpy as jnp
    from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig
    from splatformer_tpu.parallel.train2d import (make_mesh_2d,
                                                  make_train_step_2d)
    from splatformer_tpu.training import train_step as jts
    from splatformer_tpu_torch.data.convert import state_dict_from_flax

    out, scenes, jmodel, variables, init = runs
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(ORDER_PERM,
                                                            jnp.int32))
    tx = jax_sgd(variables["params"])
    state = jts.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    step = make_train_step_2d(jmodel, tx, make_mesh_2d(2, 4),
                              JaxConfig(max_per_tile=256, chunk_size=32,
                                        **RASTER))
    state, jm = step(state, jax_batch(scenes), jax.random.key(0))
    ref = state_dict_from_flax(jax.device_get(state.params),
                               jax.device_get(state.batch_stats))
    got = _load(out / "local", "local4", range(2))
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k
    for k, v in jax.device_get(jm).items():
        np.testing.assert_allclose(got[0][f"metric/{k}"], np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(got[0]["metric/num_dropped"]) == 0.0
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


def test_2d_step_processes_equal_local_shards(runs):
    """The (2, 2) process mesh (gauss exchange by AllToAll over gloo,
    gradients summed by an all-reduce) against 2 processes with
    LocalShards(2) (one backward of the summed partial losses): the same
    forward on every process, so the metrics and BatchNorm statistics
    within 1e-7 relative, and every parameter within 1e-6 of the model's
    largest update plus one float32 spacing of the parameter (the members'
    gradients are added after the backward instead of inside it, in
    another order of float32 sums, and p + update rounds to the
    parameter's spacing); the
    four processes' states bit-identical within each data row and across
    the gauss members."""
    out, _, _, _, init = runs
    local = _load(out / "local", "local2", range(2))
    procs = _load(out / "procs", "procs", range(4))
    for r in range(1, 4):
        for k in procs[0]:
            assert np.array_equal(procs[0][k], procs[r][k]), (r, k)
    gmax = max(float(np.abs(local[0][f"sd/{k}"] - n(v)).max())
               for k, v in init.items())
    assert gmax > 0
    for k, v in local[0].items():
        if k.startswith("metric/") or k.endswith((".mean", ".var")):
            np.testing.assert_allclose(procs[0][k], v, rtol=1e-7,
                                       atol=1e-9, err_msg=k)
        else:
            assert np.all(np.abs(procs[0][k] - v)
                          <= 1e-6 * gmax + np.spacing(np.abs(v))), k
