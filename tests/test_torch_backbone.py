"""Parity of the port's PTv3 FeaturePredictor with the JAX package on the CPU:
the same weights (converted from flax by data/convert.py), non-trivial BN
running statistics, evaluation mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from splatformer_tpu.data.synthetic import random_scene as jax_scene  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
from splatformer_tpu.models.point import make_point_batch as jax_point_batch  # noqa: E402
from splatformer_tpu_torch.configs.model_ptv3_base import get_config  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.data.synthetic import random_scene  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import (  # noqa: E402
    FeaturePredictor, build_feature_predictor)
from splatformer_tpu_torch.models.point import make_point_batch  # noqa: E402

TINY_PTV3 = dict(
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(2, 2, 4),
    enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(2, 2), dec_patch_size=(16, 16), stride=(1, 2),
    drop_path=0.1, pool_capacity_factors=(1.0, 0.75),
)
ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def randomize_batch_stats(tree, rng):
    """Non-trivial running statistics, so eval-mode BN really normalises."""
    if isinstance(tree, dict):
        return {k: randomize_batch_stats(v, rng) for k, v in tree.items()}
    shape = np.shape(tree)
    if np.all(np.asarray(tree) == 0):  # mean
        return rng.normal(0.0, 0.3, shape).astype(np.float32)
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)  # var


JAX_KW = dict(sh_degree=1, grid_resolution=64,
              res_feature_activation={"means": "tanh"},
              backbone_kwargs=TINY_PTV3)


@pytest.fixture(scope="module")
def variables():
    """Variables of a tiny JAX FeaturePredictor with zeroinit off, as numpy:
    params plus randomised batch_stats."""
    jmodel = JaxFP(backbone_type="PT", zeroinit=False, **JAX_KW)
    scene = jax_scene(np.random.default_rng(0), 256, sh_degree=1, n_valid=200)
    v = jax.device_get(jax.jit(lambda k, s: jmodel.init(k, s, False))(
        jax.random.key(0), scene))
    return {"params": v["params"],
            "batch_stats": randomize_batch_stats(
                v["batch_stats"], np.random.default_rng(0))}


def port_model(variables, **kw):
    model = FeaturePredictor(**JAX_KW, **kw)
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("output_type", ["res", "dc"])
def test_feature_predictor_matches_jax(variables, output_type):
    jmodel = JaxFP(backbone_type="PT", output_features_type=output_type,
                   **JAX_KW)
    tmodel = port_model(variables, output_features_type=output_type)
    jscene = jax_scene(np.random.default_rng(1), 256, sh_degree=1, n_valid=200)
    tscene = random_scene(np.random.default_rng(1), 256, sh_degree=1,
                          n_valid=200, device="cpu")
    ref, _ = jax.jit(lambda v, s: jmodel.apply(v, s, False))(variables, jscene)
    with torch.inference_mode():
        out = tmodel(tscene)
    for k in ATTRS:
        np.testing.assert_allclose(n(getattr(out, k)), n(getattr(ref, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
        # the heads really change the valid Gaussians
        assert np.abs(n(getattr(out, k))[:200]
                      - n(getattr(tscene, k))[:200]).max() > 1e-3, k
    np.testing.assert_array_equal(n(out.means)[200:], n(tscene.means)[200:])


def test_backbone_matches_jax(variables):
    """The PTv3 backbone's per-point features on their own."""
    from splatformer_tpu.models.ptv3 import PointTransformerV3 as JaxPTv3
    tmodel = port_model(variables)
    rng = np.random.default_rng(4)
    coord = rng.uniform(0.05, 0.95, (256, 3)).astype(np.float32)
    feat = rng.normal(size=(256, 23)).astype(np.float32)
    mask = np.arange(256) < 220
    feat[~mask] = 0.0
    jpb = jax_point_batch(coord, feat, mask, grid_resolution=64)
    jbackbone = JaxPTv3(in_channels=23, **TINY_PTV3)
    ref, _ = jax.jit(lambda v, pb: jbackbone.apply(v, pb, False))(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}, jpb)
    tpb = make_point_batch(torch.from_numpy(coord), torch.from_numpy(feat),
                           torch.from_numpy(mask), grid_resolution=64)
    for k in ("grid_coord", "codes", "order_perm", "inverse_perm"):
        np.testing.assert_array_equal(n(getattr(tpb, k)), n(getattr(jpb, k)))
    with torch.inference_mode():
        out = tmodel.backbone(tpb)
    np.testing.assert_allclose(n(out)[mask], n(ref)[mask], rtol=0, atol=1e-4)


def test_base_config_builds_at_full_width():
    """PTv3-base from the port's config: full widths, finite refinement;
    with turn_off_bn it builds without any BatchNorm parameter or
    statistic."""
    cfg = get_config()
    model = build_feature_predictor(cfg, device="cpu")
    widths = [m.out_features for m in model.backbone.modules()
              if isinstance(m, torch.nn.Linear)]
    assert max(widths) == 4 * 512 and model.backbone.out_channels == 96
    scene = random_scene(np.random.default_rng(0), 512, sh_degree=1,
                         n_valid=500, device="cpu")
    with torch.inference_mode():
        out = model(scene)
    # zero-init heads in residual mode: step 0 is the identity refinement
    for k in ATTRS:
        np.testing.assert_array_equal(n(getattr(out, k)), n(getattr(scene, k)))
    cfg.backbone.turn_off_bn = True
    off = build_feature_predictor(cfg, device="cpu").state_dict()
    assert not any(k.endswith(("_norm.mean", "_norm.var", "_norm.scale"))
                   for k in off)
    assert len(off) < len(model.state_dict())


def test_flash_base_config_builds_at_full_width():
    """PTv3-base with ``enable_flash``: patch 1024 in every stage, every
    block's attention through K3 (FlashAttention, the plain version on the
    CPU), the same widths and parameters as without flash; one patch of
    1024 points refines to the identity at zero init."""
    from splatformer_tpu_torch.models.ptv3 import SerializedAttention
    cfg = get_config()
    cfg.backbone.enable_flash = True
    model = build_feature_predictor(cfg, device="cpu")
    attns = [m for m in model.modules() if isinstance(m, SerializedAttention)]
    assert len(attns) == 22  # enc (2, 2, 2, 6, 2) + dec (2, 2, 2, 2)
    assert all(a.use_flash and a.patch_size == 1024 for a in attns)
    assert sorted({a.qkv.in_features // a.num_heads for a in attns}) == [
        16, 24, 32]
    cfg.backbone.enable_flash = False
    plain = build_feature_predictor(cfg, device="cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    scene = random_scene(np.random.default_rng(0), 1024, sh_degree=1,
                         n_valid=1000, device="cpu")
    with torch.inference_mode():
        out = model(scene)
    for k in ATTRS:
        np.testing.assert_array_equal(n(getattr(out, k)), n(getattr(scene, k)))
