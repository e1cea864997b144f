"""One SGD train step of a tiny FeaturePredictor with token merging
(model_ptv3_tome; random input downsampling, model_ptv3_drop, is in
tests/test_torch_downsample_train.py) against the JAX package's make_train_step on a 1-device mesh, from the
same weights and batch, f32, drop_path 0: the draws are shared (the order
shuffle fixed to one permutation in both, as tests/test_torch_train_step.py
does; drop's random scores injected into the port as the JAX package's
draws). Held at tests/test_torch_train_step.py's tolerances: every metric
within 1e-4 relative; each parameter's update within 1e-3 of its tensor's
largest update plus 2e-4 of the model's largest; the BatchNorm running
statistics within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
from splatformer_tpu.ops.types import GaussianScene as JaxScene  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig  # noqa: E402
from splatformer_tpu.parallel.mesh import make_mesh  # noqa: E402
from splatformer_tpu.training import optim as joptim  # noqa: E402
from splatformer_tpu.training import train_step as jts  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor  # noqa: E402
from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training.optim import build_optimizer  # noqa: E402
from splatformer_tpu_torch.training.train_step import (SceneBatch,  # noqa: E402
                                                       make_train_step)
from test_torch_merge_model import (MODEL_KW, RASTER, TINY, infos,  # noqa: E402
                                    jax_variables, n, request)

ORDER_PERM = (2, 0, 3, 1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def check_train_step(monkeypatch, name):
    """The JAX and the port's step of model_ptv3_<name>, compared."""
    info = infos(f"ptv3_{name}")
    noisy, gt = request()
    scores = np.array(jax.random.uniform(jax.random.key(9), (256,)))
    uniform = jax.random.uniform
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(ORDER_PERM,
                                                            jnp.int32))
    # random downsampling's (N,) draw; any other draw is the JAX one
    monkeypatch.setattr(
        jax.random, "uniform", lambda key, shape=(), *a, **k:
        jnp.asarray(scores) if tuple(shape) == (256,)
        else uniform(key, shape, *a, **k))

    jscene = JaxScene(**{k: jnp.asarray(v) for k, v in noisy.items()})
    variables = jax_variables("PT", TINY, jscene)
    jmodel = JaxFP(backbone_type="PT", zeroinit=False, additional_info=info,
                   backbone_kwargs=TINY, **MODEL_KW)
    opt_kw = dict(lr_dict={"base": 0.05, "backbone": 0.05}, eps=1e-6,
                  grad_clip_norm=2.0, optimizer_type="sgd")
    tx = joptim.build_optimizer(variables["params"], **opt_kw)
    mesh = make_mesh(n_devices=1)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jbatch = jts.SceneBatch(scene=jscene, cameras=jax_orbit(2, 32, 32),
                            images=jnp.asarray(gt), background=jnp.zeros(3))
    jstep = jts.make_train_step(jmodel, tx, mesh, JaxConfig(**RASTER))
    state, jm = jstep(state, jax.tree.map(lambda a: a[None], jbatch),
                      jax.random.key(0))
    state = jax.device_get(state)

    tmodel = FeaturePredictor(additional_info=info, backbone_kwargs=TINY,
                              **MODEL_KW)
    init = state_dict_from_flax(variables["params"], variables["batch_stats"])
    tmodel.load_state_dict(init, strict=True)
    tstep = make_train_step(tmodel, build_optimizer(tmodel, **opt_kw),
                            RasterizeConfig(**RASTER))
    tbatch = SceneBatch(
        scene=GaussianScene(**{k: torch.from_numpy(v)
                               for k, v in noisy.items()}),
        cameras=orbit_cameras(2, 32, 32, device="cpu"),
        images=torch.from_numpy(gt), background=torch.zeros(3))
    tm = tstep(tbatch, order_perm=torch.tensor(ORDER_PERM),
               downsample_scores=torch.from_numpy(scores))

    assert set(tm) == {"total_loss", "image_l1", "train_psnr", "num_dropped"}
    for k, v in tm.items():
        np.testing.assert_allclose(float(v), float(np.asarray(jm[k])[()]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    ref = state_dict_from_flax(state.params, state.batch_stats)
    got = tmodel.state_dict()
    assert set(ref) == set(got) == set(init)
    deltas = {k: (n(got[k]) - n(init[k]), n(v) - n(init[k]))
              for k, v in ref.items()}
    gmax = max(float(np.abs(dj).max()) for _, dj in deltas.values())
    assert gmax > 0
    for k, (dt, dj) in deltas.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(n(got[k]), n(ref[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            continue
        err = float(np.abs(dt - dj).max())
        assert err <= 1e-3 * float(np.abs(dj).max()) + 2e-4 * gmax, (k, err)


def test_tome_train_step_matches_jax(monkeypatch):
    check_train_step(monkeypatch, "tome")
