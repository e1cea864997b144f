"""The ``enable_flash`` path of the port (K3 in every block's attention) on
the CPU: a tiny FeaturePredictor against the JAX package's with
``use_flash=True``, its Pallas flash kernel run in TPU interpret mode, on
the same weights (data/convert.py), eval mode; and the port's train step
with flash against the port's own without it, from one state. The tiny
model's head widths are 16, 24 and 32, the three that PTv3-base has."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.experimental.pallas.ops.tpu import flash_attention as fa  # noqa: E402

from splatformer_tpu.data.synthetic import random_scene as jax_scene  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.kernels import attention  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    FeaturePredictor, init_weights)
from splatformer_tpu_torch.models.ptv3 import SerializedAttention  # noqa: E402
from splatformer_tpu_torch.ops.render import render_images_stats  # noqa: E402
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training.optim import build_optimizer  # noqa: E402
from splatformer_tpu_torch.training.train_step import (SceneBatch,  # noqa: E402
                                                       make_train_step)

TINY_FLASH = dict(
    enc_depths=(1, 1, 1), enc_channels=(32, 48, 64), enc_num_head=(2, 2, 2),
    enc_patch_size=(128,) * 3, dec_depths=(1, 1), dec_channels=(32, 48),
    dec_num_head=(2, 2), dec_patch_size=(128,) * 2, stride=(1, 2),
    drop_path=0.0, pool_capacity_factors=(1.0, 0.75),
)
MODEL_KW = dict(sh_degree=1, grid_resolution=64,
                res_feature_activation={"means": "tanh"})
ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")
NUM_BLOCKS = 5


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _count(monkeypatch, module, name):
    """Wrap ``module.name`` so that each call is counted."""
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_flash_feature_predictor_matches_jax_flash(monkeypatch):
    """Eval mode, weights of a JAX init (zeroinit off, random running
    statistics) mapped by state_dict_from_flax with strict=True: flash adds
    no parameter, so the map is the non-flash one. The JAX model runs its
    Pallas flash kernel (interpret mode) in each of the 5 blocks and the
    port K3's wrapper in each; every refined attribute within 1e-4, as the
    non-flash parity test (tests/test_torch_backbone.py) holds."""
    init_model = JaxFP(backbone_type="PT", zeroinit=False,
                       backbone_kwargs=dict(TINY_FLASH, use_flash=False),
                       **MODEL_KW)
    jscene = jax_scene(np.random.default_rng(1), 256, sh_degree=1,
                       n_valid=200)
    v = jax.device_get(jax.jit(lambda k, s: init_model.init(k, s, False))(
        jax.random.key(0), jscene))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(
        lambda a: (rng.normal(0.0, 0.3, a.shape) if not a.any()
                   else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}

    flash_calls = _count(monkeypatch, fa, "flash_attention")
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    jmodel = JaxFP(backbone_type="PT",
                   backbone_kwargs=dict(TINY_FLASH, use_flash=True),
                   **MODEL_KW)
    ref, _ = jax.jit(lambda v, s: jmodel.apply(v, s, False))(variables,
                                                             jscene)
    assert len(flash_calls) == NUM_BLOCKS

    plain_calls = _count(monkeypatch, attention, "attention_fwd_plain")
    tmodel = FeaturePredictor(**MODEL_KW, backbone_kwargs=dict(
        TINY_FLASH, use_flash=True))
    tmodel.load_state_dict(state_dict_from_flax(variables["params"],
                                                variables["batch_stats"]),
                           strict=True)
    attns = [m for m in tmodel.modules() if isinstance(m, SerializedAttention)]
    assert len(attns) == NUM_BLOCKS and all(a.use_flash for a in attns)
    assert sorted({a.qkv.in_features // a.num_heads for a in attns}) == [
        16, 24, 32]
    tscene = random_scene(np.random.default_rng(1), 256, sh_degree=1,
                          n_valid=200, device="cpu")
    with torch.inference_mode():
        out = tmodel.eval()(tscene)
    assert len(plain_calls) == NUM_BLOCKS
    for k in ATTRS:
        np.testing.assert_allclose(n(getattr(out, k)), n(getattr(ref, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
        assert np.abs(n(getattr(out, k))[:200]
                      - n(getattr(tscene, k))[:200]).max() > 1e-3, k


def _batch():
    """A perturbed 256-Gaussian scene; the ground truth is the render of the
    clean scene from 2 views at 32^2."""
    rng = np.random.default_rng(7)
    clean = random_scene(rng, 256, sh_degree=1, n_valid=230, device="cpu")
    noise = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    cams = orbit_cameras(2, 32, 32, device="cpu")
    bg = torch.zeros(3)
    with torch.no_grad():
        gt, _, _ = render_images_stats(clean, cams, bg,
                                       RasterizeConfig(max_intersects=2 ** 12))
    return SceneBatch(scene=clean.replace(means=clean.means + 0.004 * noise),
                      cameras=cams, images=gt, background=bg)


def _step(use_flash, init, compute_dtype=None):
    """One SGD step (lr 0.05 after the 2.0 clip) of the tiny model from the
    state ``init``; -> (loss, state_dict after the step)."""
    model = FeaturePredictor(**MODEL_KW, compute_dtype=compute_dtype,
                             backbone_kwargs=dict(TINY_FLASH,
                                                  use_flash=use_flash))
    model.load_state_dict(init)
    opt = build_optimizer(model, {"base": 0.05, "backbone": 0.05},
                          optimizer_type="sgd")
    step = make_train_step(model, opt, RasterizeConfig(max_intersects=2 ** 12))
    m = step(_batch(), order_perm=torch.tensor((2, 0, 3, 1)))
    return float(m["total_loss"]), {k: v.detach().clone()
                                    for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def init_state():
    model = FeaturePredictor(**MODEL_KW, backbone_kwargs=TINY_FLASH)
    init_weights(model, torch.Generator().manual_seed(0), zeroinit=False,
                 head_final_scale=0.1)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _updates(init, sd):
    keys = [k for k in init if not k.endswith((".mean", ".var"))]
    return {k: sd[k] - init[k] for k in keys}


def test_flash_train_step_matches_the_plain_attention_step(monkeypatch,
                                                           init_state):
    """float32: the same step through K3 (forward and backward) and through
    the plain matmul-softmax attention. Flash applies the scale to the
    float32 logits, the plain path to q first, so the two differ by float32
    rounding only: the loss within 1e-6 relative, every parameter's update
    within 1e-4 of its tensor's largest update plus 1e-5 of the model's
    largest (the second term for tensors whose gradient is rounding noise,
    a bias before a train-mode BatchNorm); the running statistics within
    1e-6. K3's backward ran in each of the 5 blocks."""
    bwd_calls = _count(monkeypatch, attention, "attention_bwd_plain")
    loss_f, sd_f = _step(True, init_state)
    assert len(bwd_calls) == NUM_BLOCKS
    loss_p, sd_p = _step(False, init_state)
    np.testing.assert_allclose(loss_f, loss_p, rtol=1e-6)
    du_f, du_p = _updates(init_state, sd_f), _updates(init_state, sd_p)
    gmax = max(float(d.abs().max()) for d in du_p.values())
    assert gmax > 0
    for k, dp in du_p.items():
        err = float((du_f[k] - dp).abs().max())
        assert err <= 1e-4 * float(dp.abs().max()) + 1e-5 * gmax, (k, err)
    for k in init_state:
        if k.endswith((".mean", ".var")):
            assert float((sd_f[k] - sd_p[k]).abs().max()) <= 1e-6, k


def test_bf16_flash_train_step_tracks_float32(init_state):
    """bfloat16 blocks: K3 runs in bfloat16 (P and dS rounded to bfloat16
    before their products, as the JAX kernel). Against the float32 flash
    step from the same state: the loss within 1e-3 relative (measured
    1.0e-4 on the CPU), the update at cosine >= 0.99 (0.9992); and, so that
    a float32 step cannot pass, the update's distance from the float32
    update between 0.5 and 2 times that of the plain-attention bf16 step
    (measured 0.040 against 0.045 of the update's norm)."""
    loss32, sd32 = _step(True, init_state)
    u32 = torch.cat([d.ravel() for d in _updates(init_state, sd32).values()])
    dist = {}
    for use_flash in (True, False):
        loss16, sd16 = _step(use_flash, init_state, torch.bfloat16)
        u16 = torch.cat([d.ravel()
                         for d in _updates(init_state, sd16).values()])
        if use_flash:
            np.testing.assert_allclose(loss16, loss32, rtol=1e-3)
            cos = float(u16 @ u32 / (u16.norm() * u32.norm()))
            assert cos >= 0.99, cos
        dist[use_flash] = float((u16 - u32).norm())
    assert 0.5 <= dist[True] / dist[False] <= 2.0, dist
