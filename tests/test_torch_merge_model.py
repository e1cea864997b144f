"""A tiny FeaturePredictor with each token-merging config of the JAX
package (model_ptv3_{tome,tofu,pitome,prune,patch,wpatch,algm}: merging in
the attention with the proportional-attention bias, and the independent
tome_mlp merge) against the JAX package's on the CPU, eval mode, on the
same weights (data/convert.py) and scene: every refined attribute within
1e-4, the eval step's PSNR within 1e-3 dB and SSIM within 1e-4 per view.
Patch 32 over 230 live points of 256, so the boundary patch repeats its
last point (ties). This file holds the bipartite modes and pruning and the
helpers of the other model files: test_torch_merge_model_patch.py (the
block modes and ALGM), test_torch_merge_flash.py, test_torch_merge_train.py,
test_torch_downsample_model.py and test_torch_model_options.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.configs import load_config as jax_load_config  # noqa: E402
from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
from splatformer_tpu.ops.render import render_images_stats as jax_render  # noqa: E402
from splatformer_tpu.ops.types import GaussianScene as JaxScene  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig  # noqa: E402
from splatformer_tpu.training import metrics as jmetrics  # noqa: E402
from splatformer_tpu_torch.configs import load_config  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor  # noqa: E402
from splatformer_tpu_torch.ops.render import render_images  # noqa: E402
from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training.train_step import (SceneBatch,  # noqa: E402
                                                       make_eval_step)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = dict(
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(2, 2, 4),
    enc_patch_size=(32,) * 3, dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(2, 2), dec_patch_size=(32,) * 2, stride=(1, 2),
    drop_path=0.0, pool_capacity_factors=(1.0, 0.75),
)
MODEL_KW = dict(sh_degree=1, grid_resolution=64,
                res_feature_activation={"means": "tanh"})
ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")
FIELDS = ATTRS + ("mask",)
RASTER = dict(max_intersects=2 ** 12, tiles_per_gauss=16)


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def infos(name):
    """The config's additional_info in both packages (they must agree)."""
    j = dict(jax_load_config("model", name).additional_info)
    p = load_config("model", name).additional_info
    assert p == j, (name, p, j)
    return p


def request():
    """(perturbed scene arrays, ground truth (2, 32, 32, 3)): the port's
    render of the clean scene."""
    rng = np.random.default_rng(7)
    clean = random_scene(rng, 256, 1, 230, device="cpu")
    noisy = {k: n(getattr(clean, k)) for k in FIELDS}
    noisy["means"] = (noisy["means"] + 0.004 * rng.normal(
        size=(256, 3))).astype(np.float32)
    with torch.no_grad():
        gt, _ = render_images(clean, orbit_cameras(2, 32, 32, device="cpu"),
                              torch.zeros(3), RasterizeConfig(**RASTER))
    return noisy, n(gt)


_VARIABLES = {}


def jax_variables(backbone_type, backbone, scene, seed=0):
    """A JAX init (zeroinit off, each head's last layer scaled by 0.1, so
    the refined scene still renders) with random running statistics, so
    eval BatchNorm is not the identity. Merging, downsampling and flash add
    no parameter, so the init runs without them, once per backbone."""
    backbone = {k: v for k, v in backbone.items() if k != "use_flash"}
    key = (backbone_type, repr(sorted(backbone.items())))
    if key in _VARIABLES:
        return _VARIABLES[key]
    jmodel = JaxFP(backbone_type=backbone_type, zeroinit=False,
                   backbone_kwargs=backbone, **MODEL_KW)
    v = jax.device_get(jax.jit(lambda k, s: jmodel.init(k, s, False))(
        jax.random.key(3), scene))
    params = jax.tree.map(np.asarray, v["params"])
    for name, head in params.items():
        if name.startswith("head_"):
            last = head[max(head, key=lambda d: int(d.split("_")[1]))]
            last["kernel"] = last["kernel"] * np.float32(0.1)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: (rng.normal(0.0, 0.3, a.shape) if not a.any()
                   else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v.get("batch_stats", {}))
    _VARIABLES[key] = {"params": params, "batch_stats": stats}
    return _VARIABLES[key]


def jax_eval(scene, gt):
    """The JAX eval step's render and metrics of a refined scene (the same
    function for every config, so one compile)."""
    rgb, _, stats = jax_render(scene, jax_orbit(2, 32, 32), jnp.zeros(3),
                               JaxConfig(**RASTER))
    return jmetrics.psnr(rgb, gt), jmetrics.ssim(rgb, gt), \
        stats["num_dropped"]


_jax_eval = jax.jit(jax_eval)


def check_config(info, jax_backbone, port_backbone, backbone_type="PT",
                 downsample_scores=None):
    """The JAX FeaturePredictor and the port's on the JAX init's weights:
    refined attributes within 1e-4, PSNR 1e-3 dB, SSIM 1e-4. Returns the
    port model."""
    noisy, gt = request()
    jscene = JaxScene(**{k: jnp.asarray(v) for k, v in noisy.items()})
    jmodel = JaxFP(backbone_type=backbone_type, zeroinit=False,
                   additional_info=info, backbone_kwargs=jax_backbone,
                   **MODEL_KW)
    variables = jax_variables(backbone_type, jax_backbone, jscene)
    ref = jax.jit(lambda v, s: jmodel.apply(v, s, False)[0])(variables,
                                                               jscene)
    psnr_j, ssim_j, drop_j = _jax_eval(ref, jnp.asarray(gt))

    tmodel = FeaturePredictor(backbone_type=backbone_type,
                              additional_info=info,
                              backbone_kwargs=port_backbone, **MODEL_KW)
    tmodel.load_state_dict(state_dict_from_flax(variables["params"],
                                                variables["batch_stats"]),
                           strict=True)
    tscene = GaussianScene(**{k: torch.from_numpy(v)
                              for k, v in noisy.items()})
    with torch.inference_mode():
        out = tmodel.eval()(tscene, downsample_scores=downsample_scores)
    for k in ATTRS:
        np.testing.assert_allclose(n(getattr(out, k)), n(getattr(ref, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    # the model really refines (the heads are not zero)
    assert np.abs(n(out.means) - noisy["means"])[:230].max() > 1e-3
    # the eval step; with injected draws, its render and metrics of the
    # refined scene
    batch = SceneBatch(scene=tscene if downsample_scores is None else out,
                       cameras=orbit_cameras(2, 32, 32, device="cpu"),
                       images=torch.from_numpy(gt), background=torch.zeros(3))
    _, _, psnr_t, ssim_t, drop_t = make_eval_step(
        tmodel, RasterizeConfig(**RASTER),
        render_input=downsample_scores is not None)(batch)
    np.testing.assert_allclose(n(psnr_t), n(psnr_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(ssim_t), n(ssim_j), rtol=0, atol=1e-4)
    assert int(drop_t) == int(drop_j) == 0
    return tmodel


def check_merge_config(name):
    """model_ptv3_<name>'s additional_info (tome_attention and tome_mlp on,
    the config's rate) in every block."""
    info = infos(f"ptv3_{name}")
    assert info["tome_attention"] and info["tome_mlp"] and info["r"] > 0
    model = check_config(info, TINY, TINY)
    blocks = [m for m in model.modules() if hasattr(m, "mlp_merge_info")]
    assert len(blocks) == 5 and all(
        b.mlp_merge_info is not None and b.attn.merge_info is not None
        for b in blocks)


@pytest.mark.parametrize("name", ["tome", "tofu", "pitome", "prune"])
def test_merge_config_matches_jax(name):
    check_merge_config(name)
