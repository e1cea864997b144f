"""The port's train step against the JAX package's make_train_step on a
1-device mesh (a tiny FeaturePredictor, f32 and bf16), and the port's own
train-step behaviour: the pretrain loss at zero init, a falling loss, the
generator's replay. The pieces (gradients, BatchNorm, optimizer, LPIPS)
are in tests/test_torch_grads.py. Each tolerance is stated where it is
used."""
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
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    FeaturePredictor, init_weights)
from splatformer_tpu_torch.ops.render import render_images_stats  # noqa: E402
from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training.optim import build_optimizer  # noqa: E402
from splatformer_tpu_torch.training.train_step import (SceneBatch,  # noqa: E402
                                                       make_train_step)

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU runs: torch's default, a
    thread per core in each of the suite's parallel workers,
    oversubscribes the cores they share
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")
FIELDS = ATTRS + ("mask",)


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def scene_arrays(seed, n_pts=256, n_valid=230):
    """A clean scene and a perturbed copy of it, as dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    clean = {k: n(getattr(random_scene(rng, n_pts, 1, n_valid, device="cpu"),
                          k)) for k in FIELDS}
    noisy = dict(clean)
    noisy["means"] = (clean["means"] + 0.004 * rng.normal(
        size=clean["means"].shape)).astype(np.float32)
    noisy["scales"] = (clean["scales"] + 0.1 * rng.normal(
        size=clean["scales"].shape)).astype(np.float32)
    return clean, noisy


TINY_PTV3 = dict(
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(2, 2, 4),
    enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(2, 2), dec_patch_size=(16, 16), stride=(1, 2),
    drop_path=0.0, pool_capacity_factors=(1.0, 0.75),
)
MODEL_KW = dict(sh_degree=1, grid_resolution=64,
                res_feature_activation={"means": "tanh"},
                backbone_kwargs=TINY_PTV3)
ORDER_PERM = (2, 0, 3, 1)
RASTER = dict(max_intersects=2 ** 12, tiles_per_gauss=16)


def _batches(seed):
    """(JAX batch with its device axis, port batch) of one perturbed scene;
    the ground truth is the port's render of the clean scene (2 views at
    32^2), the same numpy array for both."""
    clean, noisy = scene_arrays(seed)
    bg = np.zeros(3, np.float32)
    cams = orbit_cameras(2, 32, 32, device="cpu")
    with torch.no_grad():
        gt, _, _ = render_images_stats(
            GaussianScene(**{k: torch.tensor(v) for k, v in clean.items()}),
            cams, torch.tensor(bg), RasterizeConfig(**RASTER))
    gt = n(gt)
    jbatch = jts.SceneBatch(
        scene=JaxScene(**{k: jnp.asarray(v) for k, v in noisy.items()}),
        cameras=jax_orbit(2, 32, 32), images=jnp.asarray(gt),
        background=jnp.asarray(bg))
    tbatch = SceneBatch(
        scene=GaussianScene(**{k: torch.tensor(v) for k, v in noisy.items()}),
        cameras=cams, images=torch.tensor(gt), background=torch.tensor(bg))
    return jax.tree.map(lambda a: a[None], jbatch), tbatch


@pytest.fixture(scope="module")
def jax_variables():
    """The tiny JAX model's initial variables, made once for this module's
    tests: the compute dtype changes no parameter (flax keeps them float32),
    and an eval-mode init draws no order shuffle. Host copies: the train
    step donates the device buffers it is given."""
    jbatch, _ = _batches(7)
    jmodel = JaxFP(backbone_type="PT", zeroinit=False, **MODEL_KW)
    scene0 = jax.tree.map(lambda a: a[0], jbatch.scene)
    return jax.device_get(jax.jit(lambda k, s: jmodel.init(k, s, False))(
        jax.random.key(3), scene0))


def _train_both(monkeypatch, variables, compute_dtype, steps, lr=1e-3,
                eps=1e-6, opt="adam"):
    """The same tiny model and weights trained ``steps`` steps by the JAX
    package's make_train_step (1-device mesh, its order shuffle fixed to
    ORDER_PERM) and by the port. Returns (initial state_dict, JAX state,
    JAX metrics per step, port model, port metrics per step)."""
    # jax.random streams cannot be reproduced in torch: fix JAX's order
    # shuffle and hand the same permutation to the port
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(ORDER_PERM,
                                                            jnp.int32))
    jbatch, tbatch = _batches(7)
    jmodel = JaxFP(backbone_type="PT", zeroinit=False,
                   compute_dtype=compute_dtype, **MODEL_KW)
    opt_kw = dict(lr_dict={"base": lr, "backbone": lr}, eps=eps,
                  grad_clip_norm=2.0, optimizer_type=opt)
    tx = joptim.build_optimizer(variables["params"], **opt_kw)
    mesh = make_mesh(n_devices=1)
    # placed as the step returns it, so that step 2 reuses step 1's compile
    state = jax.device_put(jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"])),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    tmodel = FeaturePredictor(
        **MODEL_KW, compute_dtype=None if compute_dtype is None
        else getattr(torch, compute_dtype))
    init = state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats))
    tmodel.load_state_dict(init)
    tstep = make_train_step(tmodel, build_optimizer(tmodel, **opt_kw),
                            RasterizeConfig(**RASTER))
    jstep = jts.make_train_step(jmodel, tx, mesh,
                                JaxConfig(use_pallas=True, **RASTER))
    jm, tm = [], []
    for i in range(steps):
        state, m = jstep(state, jbatch, jax.random.key(i))
        jm.append(jax.device_get(m))
        tm.append({k: float(v) for k, v in tstep(
            tbatch, order_perm=torch.tensor(ORDER_PERM)).items()})
    return init, jax.device_get(state), jm, tmodel, tm


def test_train_step_matches_jax(monkeypatch, jax_variables):
    """Two f32 steps, drop_path 0, SGD at lr 0.05 after the 2.0 global-norm
    clip, so that each parameter's update is the gradient itself: every
    metric of each step within 1e-4 relative; every parameter's update
    after step 2 within 1e-3 of that tensor's largest update plus 2e-4 of
    the model's largest (the second term covers tensors whose gradient is
    rounding noise in both frameworks, such as a bias just before a
    train-mode BatchNorm); the BatchNorm running statistics within 1e-5,
    mapped back through data/convert.py one to one."""
    init, state, jm, tmodel, tm = _train_both(monkeypatch, jax_variables,
                                              None, 2, lr=0.05, opt="sgd")
    for j, t in zip(jm, tm):
        assert set(t) == {"total_loss", "image_l1", "train_psnr",
                          "num_dropped"}
        for k in t:
            np.testing.assert_allclose(t[k], float(np.asarray(j[k])[()]),
                                       rtol=1e-4, atol=1e-6)
    assert tm[1]["total_loss"] < tm[0]["total_loss"]
    ref = state_dict_from_flax(state.params, state.batch_stats)
    got = tmodel.state_dict()
    assert set(ref) == set(got) == set(init)
    deltas = {k: (n(got[k]) - n(init[k]), n(v) - n(init[k]))
              for k, v in ref.items()}
    gmax = max(float(np.abs(dj).max()) for _, dj in deltas.values())
    for k, (dt, dj) in deltas.items():
        if k.endswith((".mean", ".var")) and "norm" in k:
            np.testing.assert_allclose(n(got[k]), n(ref[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            continue
        err = float(np.abs(dt - dj).max())
        assert err <= 1e-3 * float(np.abs(dj).max()) + 2e-4 * gmax, k


def test_bf16_train_step_matches_jax_loosely(monkeypatch, jax_variables):
    """One step with bfloat16 block compute in both frameworks, against
    the port's own f32 step from the same state. The two frameworks round
    at different places (the port's conv sums its 27 taps in one
    f32-accumulated matmul, the JAX package per tap in bf16; XLA on the CPU
    fuses elementwise chains), so at this 16-channel width the port's and
    JAX's bf16 updates lie as far from each other as from the f32 update
    (0.027 and 0.024 in norm, against updates at cosine 0.94). What is
    held: the loss within 1% of the JAX bf16 loss; the flattened parameter
    update at cosine >= 0.9 with JAX's; and, so that an f32 step cannot
    pass, the size of the bf16 perturbation: the distance of the port's
    bf16 update from the port's f32 update between 0.5 and 2 times the
    distance of JAX's bf16 update from it. Parameters and statistics stay
    float32."""
    init, state, jm, tmodel, tm = _train_both(monkeypatch, jax_variables,
                                              "bfloat16", 1, lr=0.05,
                                              opt="sgd")
    np.testing.assert_allclose(tm[0]["total_loss"],
                               float(np.asarray(jm[0]["total_loss"])),
                               rtol=1e-2)
    ref = state_dict_from_flax(state.params, state.batch_stats)
    got = tmodel.state_dict()
    keys = [k for k in ref if not k.endswith((".mean", ".var"))]

    def update(sd):
        return np.concatenate([(n(sd[k]) - n(init[k])).ravel()
                               for k in keys])

    dt, dj = update(got), update(ref)
    cos = float(dt @ dj / (np.linalg.norm(dt) * np.linalg.norm(dj)))
    assert cos >= 0.9, cos
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in got.values())

    f32 = FeaturePredictor(**MODEL_KW)
    f32.load_state_dict(init)
    _, tbatch = _batches(7)
    step = make_train_step(f32, build_optimizer(
        f32, {"base": 0.05, "backbone": 0.05}, eps=1e-6, optimizer_type="sgd"),
        RasterizeConfig(**RASTER))
    step(tbatch, order_perm=torch.tensor(ORDER_PERM))
    d32 = update(f32.state_dict())
    ratio = float(np.linalg.norm(dt - d32) / np.linalg.norm(dj - d32))
    assert 0.5 <= ratio <= 2.0, ratio


def _tiny_port(seed=0, drop_path=0.0, zeroinit=False):
    model = FeaturePredictor(**dict(MODEL_KW, backbone_kwargs=dict(
        TINY_PTV3, drop_path=drop_path)))
    init_weights(model, torch.Generator().manual_seed(seed),
                 zeroinit=zeroinit, head_final_scale=0.1)
    return model


def test_pretrain_loss_is_zero_at_zero_init():
    """Zero-initialised heads refine nothing, so every per-attribute
    pretrain L1 is exactly 0 (no rendering involved)."""
    _, tbatch = _batches(7)
    model = _tiny_port(zeroinit=True)
    step = make_train_step(model, build_optimizer(model, {"base": 1e-3}),
                           pretrain=True)
    m = step(tbatch, torch.Generator().manual_seed(0))
    assert set(m) == {"total_loss", "pretrain_loss"} | {
        f"pretrain/{a}" for a in ATTRS}
    assert all(float(v) == 0.0 for v in m.values())


def test_train_steps_reduce_loss_and_follow_the_generator():
    """Six steps of the recipe's Adam (eps 1e-15, clip 2.0) with drop_path
    0.3 and shuffled orders: the loss falls by more than 15%, the render
    drops nothing, and the same generator seed replays the same losses
    while another seed does not. lr 3e-4: with eps 1e-15 Adam's first steps
    move every weight by about lr whatever its gradient, and at lr 1e-2
    that throws this random 16-channel model's splats out of view."""
    _, tbatch = _batches(7)

    def run(seed):
        model = _tiny_port(drop_path=0.3)
        opt = build_optimizer(model, {"base": 3e-4, "backbone": 3e-4})
        step = make_train_step(model, opt, RasterizeConfig(**RASTER))
        g = torch.Generator().manual_seed(seed)
        return [step(tbatch, g) for _ in range(6)]

    a, b, c = run(0), run(0), run(1)
    losses = [float(m["total_loss"]) for m in a]
    assert losses[-1] < 0.85 * losses[0], losses
    assert all(float(m["num_dropped"]) == 0 for m in a)
    # the CPU's threaded scatter-adds in the backward may sum in another
    # order from run to run: replay within 1e-5 relative
    np.testing.assert_allclose([float(m["total_loss"]) for m in b], losses,
                               rtol=1e-5)
    assert np.abs(np.array([float(m["total_loss"]) for m in c])
                  - losses).max() > 1e-3
