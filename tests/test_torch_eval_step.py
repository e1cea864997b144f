"""The port's eval step against the JAX package's make_eval_step on the CPU:
the same scene, views, ground truth and (converted) weights; PSNR within
1e-3 dB and SSIM within 1e-4 per view. Also the metrics alone and the
device rule of the entry points."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.models.feature_predictor import FeaturePredictor as JaxFP  # noqa: E402
from splatformer_tpu.ops.render import render_images as jax_render  # noqa: E402
from splatformer_tpu.ops.types import GaussianScene as JaxScene  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig  # noqa: E402
from splatformer_tpu.parallel.mesh import make_mesh  # noqa: E402
from splatformer_tpu.training import metrics as jmetrics  # noqa: E402
from splatformer_tpu.training.train_step import SceneBatch as JaxBatch  # noqa: E402
from splatformer_tpu.training.train_step import make_eval_step as jax_eval  # noqa: E402
from splatformer_tpu_torch.data.convert import state_dict_from_flax  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor  # noqa: E402
from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training import metrics as tmetrics  # noqa: E402
from splatformer_tpu_torch.training.train_step import (SceneBatch,  # noqa: E402
                                                       make_eval_step)

TINY_PTV3 = dict(
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(2, 2, 4),
    enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(2, 2), dec_patch_size=(16, 16), stride=(1, 2),
    drop_path=0.1, pool_capacity_factors=(1.0, 0.75),
)
MODEL_KW = dict(sh_degree=1, grid_resolution=64,
                res_feature_activation={"means": "tanh"},
                backbone_kwargs=TINY_PTV3)
FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest", "mask")


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def scene_arrays(seed, n_pts=256, n_valid=230):
    """A clean scene and a perturbed copy of it, as dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    clean = {k: np.asarray(getattr(random_scene(rng, n_pts, 1, n_valid,
                                                device="cpu"), k))
             for k in FIELDS}
    noisy = dict(clean)
    noisy["means"] = (clean["means"] + 0.004 * rng.normal(
        size=clean["means"].shape)).astype(np.float32)
    noisy["scales"] = (clean["scales"] + 0.1 * rng.normal(
        size=clean["scales"].shape)).astype(np.float32)
    return clean, noisy


def test_metrics_match_jax(rng):
    a = rng.uniform(size=(3, 40, 36, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    for tf, jf in ((tmetrics.psnr, jmetrics.psnr), (tmetrics.ssim, jmetrics.ssim)):
        np.testing.assert_allclose(
            n(tf(torch.from_numpy(a), torch.from_numpy(b))),
            np.asarray(jf(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("render_input", [False, True])
def test_eval_step_matches_jax(render_input):
    clean, noisy = scene_arrays(7)
    bg = np.zeros(3, np.float32)
    jcfg = JaxConfig(max_intersects=2 ** 12, tiles_per_gauss=16,
                     use_pallas=True)
    jcams = jax_orbit(2, 32, 32)
    gt, _ = jax_render(JaxScene(**{k: jnp.asarray(v) for k, v in clean.items()}),
                       jcams, jnp.asarray(bg), jcfg)
    gt = np.asarray(gt)

    jmodel = JaxFP(backbone_type="PT", zeroinit=False, **MODEL_KW)
    jscene = JaxScene(**{k: jnp.asarray(v) for k, v in noisy.items()})
    variables = jax.device_get(jax.jit(lambda k, s: jmodel.init(k, s, False))(
        jax.random.key(3), jscene))
    batch = JaxBatch(scene=jscene, cameras=jcams, images=jnp.asarray(gt),
                     background=jnp.asarray(bg))
    batch = jax.tree.map(lambda a: a[None], batch)
    rgb_j, _, psnr_j, ssim_j, drop_j = jax_eval(
        jmodel, make_mesh(n_devices=1), jcfg, render_input=render_input)(
        variables["params"], variables["batch_stats"], batch)

    tmodel = FeaturePredictor(**MODEL_KW)
    tmodel.load_state_dict(state_dict_from_flax(variables["params"],
                                                variables["batch_stats"]))
    tbatch = SceneBatch(
        scene=GaussianScene(**{k: torch.from_numpy(v) for k, v in
                               noisy.items()}),
        cameras=orbit_cameras(2, 32, 32, device="cpu"),
        images=torch.tensor(gt), background=torch.from_numpy(bg))
    step = make_eval_step(tmodel, RasterizeConfig(max_intersects=2 ** 12,
                                                  tiles_per_gauss=16),
                          render_input=render_input)
    rgb_t, alpha_t, psnr_t, ssim_t, drop_t = step(tbatch)

    assert rgb_t.shape == (2, 32, 32, 3) and alpha_t.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(n(psnr_t), np.asarray(psnr_j)[0], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(n(ssim_t), np.asarray(ssim_j)[0], rtol=0,
                               atol=1e-4)
    assert int(drop_t) == int(np.asarray(drop_j)[0])
    # the refinement really changed the render (and PSNR is not saturated)
    assert np.all(n(psnr_t) < 60.0)
    if not render_input:
        assert float(np.abs(n(rgb_t) - np.asarray(rgb_j)[0]).max()) < 1e-3


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_scene(np.random.default_rng(0), 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orbit_cameras(1, 16, 16)
