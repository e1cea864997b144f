"""The port's per-scene 3DGS fit (training/fit_gs.py) against the JAX
package's: init_state exactly; one fit step's loss and every parameter
gradient against jax.value_and_grad of the same loss (the JAX side renders
through its chunked path, use_pallas=False, as tests/test_fit_gs.py does);
the fit optimizer and build_gs_optimizer against optax fed the same
gradients; densify on a forged state with the JAX draw of offset
directions; and the slot order of lax.top_k. The torch-only fit is
tests/test_torch_fit_psnr.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from splatformer_tpu.data.synthetic import single_camera as j_single  # noqa: E402
from splatformer_tpu.ops.render import render_image as j_render_image  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxRaster  # noqa: E402
from splatformer_tpu.training import fit_gs as jf  # noqa: E402
from splatformer_tpu.training import metrics as jmetrics  # noqa: E402
from splatformer_tpu.training.optim import build_gs_optimizer as j_gs_opt  # noqa: E402
from splatformer_tpu_torch.data.synthetic import (orbit_cameras,  # noqa: E402
                                                  random_scene)
from splatformer_tpu_torch.ops.render import render_images  # noqa: E402
from splatformer_tpu_torch.ops.types import Camera, RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training import fit_gs as tf  # noqa: E402
from splatformer_tpu_torch.training.optim import build_gs_optimizer  # noqa: E402

JRC = JaxRaster(max_intersects=2 ** 13, tiles_per_gauss=16,
                max_per_tile=1024, chunk_size=32, use_pallas=False)
TRC = RasterizeConfig(max_intersects=2 ** 13, tiles_per_gauss=16)
LOSS_RTOL = 1e-5     # one step's loss, relative
GRAD_TOL = 1e-4      # each gradient, relative to its largest magnitude
OPT_RTOL = 1e-6      # optimizer updates fed the same gradients


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    return jf.FitConfig(**kw), tf.FitConfig(**kw)


def _target(hw, views, seed=11):
    """A chunky, opaque target rendered by the port (plain K1 on the CPU):
    (images (V, H, W, 3), cameras)."""
    gt = random_scene(np.random.default_rng(seed), 384, device="cpu")
    gt = gt.replace(scales=torch.clamp(gt.scales + 1.5, -5.0, -2.5),
                    opacities=gt.opacities + 2.0)
    cams = orbit_cameras(views, hw, hw, device="cpu")
    with torch.no_grad():
        imgs = render_images(gt, cams, torch.zeros(3), TRC)[0]
    return torch.clamp(imgs, 0.0, 1.0), cams


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_init_state_exact():
    jcfg, tcfg = _configs(capacity=512)
    tx = jf.build_fit_optimizer(jcfg)
    rng = np.random.default_rng(0)
    pts, cols = rng.uniform(size=(200, 3)), rng.uniform(size=(200, 3))
    for kw in ({"n_init": 128, "seed": 0}, {"points": pts, "colors": cols,
                                            "seed": 4}):
        j = jf.init_state(jcfg, tx, **kw)
        t = tf.init_state(tcfg, device="cpu", **kw)
        for k in tf.ATTRS:
            assert np.array_equal(_np(j.params[k]), _np(t.params[k])), k
        assert np.array_equal(_np(j.mask), _np(t.mask))
        assert not _np(t.grad_accum).any() and not _np(t.grad_count).any()


def test_fit_step_loss_and_gradients():
    """One step on a state whose quats, scales and SH are spread (init's
    identity quats get no gradient), both packages from the same arrays;
    the step's densification statistics too."""
    jcfg, tcfg = _configs(capacity=512)
    imgs, cams = _target(32, 3)
    state = tf.init_state(tcfg, n_init=160, seed=2, device="cpu")
    rng = np.random.default_rng(9)
    live = _np(state.mask)
    host = {k: _np(p).copy() for k, p in state.params.items()}
    host["quats"][live] = rng.normal(size=(live.sum(), 4))
    host["scales"][live] += rng.normal(0, 0.4, (live.sum(), 3))
    host["features_rest"][live] = rng.normal(0, 0.2, (live.sum(), 3, 3))
    with torch.no_grad():
        for k, v in host.items():
            state.params[k].copy_(torch.from_numpy(v))
    band = np.array([1.0, 1.0, 0.0], np.float32)
    view, image = 1, _np(imgs[1])

    def jloss(params):
        p = dict(params)
        p["features_rest"] = p["features_rest"] * jnp.asarray(band)[:, None]
        rgb, _ = j_render_image(jf._scene(p, jnp.asarray(live)),
                                j_single(_jax_cams(cams), view),
                                jnp.zeros(3), JRC)
        l1 = jnp.mean(jnp.abs(rgb - image))
        s = jmetrics.ssim(rgb[None], jnp.asarray(image)[None])[0]
        return (1.0 - jcfg.ssim_weight) * l1 + jcfg.ssim_weight * (1.0 - s)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in host.items()})

    cam = Camera(c2w=cams.c2w[1:2], fx=cams.fx[1:2], fy=cams.fy[1:2],
                 cx=cams.cx[1:2], cy=cams.cy[1:2], width=32, height=32)
    loss, _, _ = tf.fit_loss(tcfg, TRC, state.params, state.mask, cam,
                             imgs[1], torch.zeros(3), torch.from_numpy(band))
    grads = torch.autograd.grad(loss, [state.params[k] for k in tf.ATTRS])
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for k, g in zip(tf.ATTRS, grads):
        want = _np(jg[k])
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(_np(g), want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)
    m = tf.fit_step(tcfg, TRC, state, cam, imgs[1], torch.zeros(3),
                    torch.from_numpy(band))
    assert float(m["loss"]) == loss.item()
    gnorm = np.linalg.norm(_np(grads[0]), axis=-1) * float(cams.fx[1])
    np.testing.assert_allclose(_np(state.grad_accum), gnorm, rtol=1e-6)
    assert np.array_equal(_np(state.grad_count), (gnorm > 0).astype(
        np.float32))


def _jax_cams(cams):
    from splatformer_tpu.ops.types import Camera as JaxCamera
    return JaxCamera(c2w=jnp.asarray(_np(cams.c2w)), fx=jnp.asarray(_np(
        cams.fx)), fy=jnp.asarray(_np(cams.fy)), cx=jnp.asarray(_np(
            cams.cx)), cy=jnp.asarray(_np(cams.cy)), width=cams.width,
        height=cams.height)


def _shared_grads(rng, params, mask):
    return {k: (rng.normal(size=v.shape) * mask.reshape(
        (-1,) + (1,) * (v.ndim - 1))).astype(np.float32)
        for k, v in params.items()}


def _adam_states(opt_state):
    """{attr: ScaleByAdamState} of build_fit_optimizer's multi_transform."""
    return {k: s.inner_state[0] for k, s in opt_state.inner_states.items()}


@pytest.fixture(scope="module")
def stepped():
    """Both fit optimizers after 3 updates from one init_state, fed the same
    gradients (the means' learning rate decays over 10 steps)."""
    jcfg, tcfg = _configs(capacity=256, steps=10, lr_means=2e-3,
                          lr_means_final=2e-4, densify_budget_frac=0.25,
                          densify_grad_thresh=0.0)
    tx = jf.build_fit_optimizer(jcfg)
    j = jf.init_state(jcfg, tx, n_init=64, seed=1)
    t = tf.init_state(tcfg, n_init=64, seed=1, device="cpu")
    rng = np.random.default_rng(5)
    params, opt_state = j.params, j.opt_state
    history = []
    for _ in range(3):
        g = _shared_grads(rng, j.params, _np(j.mask))
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        t.opt.step(t.params, {k: torch.from_numpy(v) for k, v in g.items()})
        history.append(({k: _np(v) for k, v in params.items()},
                        {k: _np(p).copy() for k, p in t.params.items()}))
    return jcfg, tcfg, tx, j._replace(params=params, opt_state=opt_state), \
        t, history


def test_fit_optimizer_matches_optax(stepped):
    _, tcfg, _, j, t, history = stepped
    for want, got in history:
        for k in tf.ATTRS:
            np.testing.assert_allclose(got[k], want[k], rtol=OPT_RTOL,
                                       atol=1e-12, err_msg=k)
    for k, adam in _adam_states(j.opt_state).items():
        assert int(adam.count) == t.opt.count[k] == 3
        np.testing.assert_allclose(_np(t.opt.mu[k]), _np(adam.mu[k]),
                                   rtol=OPT_RTOL, atol=1e-12)
        np.testing.assert_allclose(_np(t.opt.nu[k]), _np(adam.nu[k]),
                                   rtol=OPT_RTOL, atol=1e-12)
    # the means' schedule: optax.exponential_decay at counts 0, 1, 2
    sched = optax.exponential_decay(tcfg.lr_means, tcfg.steps,
                                    tcfg.lr_means_final / tcfg.lr_means)
    for c in range(3):
        assert t.opt.lrs["means"](c) == pytest.approx(float(sched(c)),
                                                      rel=OPT_RTOL)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_build_gs_optimizer_matches_optax(kind):
    rng = np.random.default_rng(6)
    host = {"means": rng.normal(size=(40, 3)).astype(np.float32),
            "opacities": rng.normal(size=(40, 1)).astype(np.float32)}
    lrs = {"base": 1e-2, "means": 1e-3}
    tx = j_gs_opt({k: jnp.asarray(v) for k, v in host.items()}, lrs, kind)
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    opt = build_gs_optimizer(tp, lrs, kind)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in host.items()}
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, up)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in host:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                       rtol=OPT_RTOL, atol=1e-12)


def test_densify_matches_jax(stepped):
    """Split / clone / prune on a forged state (spread scales and quats,
    every live Gaussian a candidate, Adam moments from 3 updates) with the
    JAX draw of the offset directions. Mask, parameters and moments are
    exact but the split children's means: XLA's exp differs from torch's
    by one ulp in ~10% of float32 inputs, so those are held to 4 float32
    ulps at 1.0. Every count is kept."""
    jcfg, tcfg, tx, j, t, _ = stepped
    rng = np.random.default_rng(8)
    host = {k: _np(v).copy() for k, v in j.params.items()}
    host["scales"][:64] = rng.uniform(-6.0, -3.0, (64, 3))
    host["quats"][:64] = rng.normal(size=(64, 4))
    host["opacities"][60:64] = -8.0      # pruned after densify
    acc = np.where(_np(j.mask), rng.uniform(0, 1, 256), 0).astype(np.float32)
    acc[10] = acc[11]                    # a tie in the ranking
    j = j._replace(params={k: jnp.asarray(v) for k, v in host.items()},
                   grad_accum=jnp.asarray(acc), grad_count=jnp.ones(256))
    with torch.no_grad():
        for k, v in host.items():
            t.params[k].copy_(torch.from_numpy(v))
    t.grad_accum, t.grad_count = torch.from_numpy(acc), torch.ones(256)

    key = jax.random.key(0)
    directions = _np(jax.random.normal(key, (tf.densify_budget(tcfg), 3)))
    j2, n_j = jf.make_densify(jcfg, tx)(j, key)
    n_t = tf.densify(tcfg, t, offset_dir=torch.tensor(directions))
    assert int(n_t) == int(n_j) > 0
    assert np.array_equal(_np(t.mask), _np(j2.mask))
    assert not _np(t.mask)[60:64].any()
    for k in tf.ATTRS:
        if k == "means":
            np.testing.assert_allclose(_np(t.params[k]), _np(j2.params[k]),
                                       rtol=0, atol=4 * 2.0 ** -23)
        else:
            assert np.array_equal(_np(t.params[k]), _np(j2.params[k])), k
    for k, adam in _adam_states(j2.opt_state).items():
        assert np.array_equal(_np(t.opt.mu[k]), _np(adam.mu[k])), k
        assert np.array_equal(_np(t.opt.nu[k]), _np(adam.nu[k])), k
        assert int(adam.count) == t.opt.count[k] == 3
    assert not _np(t.grad_accum).any() and not _np(t.grad_count).any()


def test_top_slots_is_lax_top_k_order():
    """Largest first, the lower index first among equal scores, as
    jax.lax.top_k orders them on the CPU."""
    rng = np.random.default_rng(3)
    score = rng.integers(0, 5, 300).astype(np.float32)
    score[rng.uniform(size=300) < 0.3] = -np.inf
    for k in (1, 17, 300):
        jv, ji = jax.lax.top_k(jnp.asarray(score), k)
        tv, ti = tf.top_slots(torch.from_numpy(score), k)
        assert np.array_equal(_np(ti), _np(ji))
        assert np.array_equal(_np(tv), _np(jv))
