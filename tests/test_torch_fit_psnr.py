"""A torch-only per-scene fit (training/fit_gs.py) at
tests/test_fit_gs.py::test_fit_improves_psnr's size and settings, and the
opacity reset. Kept apart from tests/test_torch_fit_gs.py, the parity
tests, so the suite's workers can run the two files side by side."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.data.synthetic import (orbit_cameras,  # noqa: E402
                                                  random_scene)
from splatformer_tpu_torch.ops.render import render_images  # noqa: E402
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training import fit_gs as tf  # noqa: E402

RASTER = RasterizeConfig(max_intersects=2 ** 13, tiles_per_gauss=16)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _target(hw=48, views=5):
    """tests/test_fit_gs.py's target: 384 chunky, opaque Gaussians under 5
    orbit views, rendered by the port."""
    gt = random_scene(np.random.default_rng(11), 384, device="cpu")
    gt = gt.replace(scales=torch.clamp(gt.scales + 1.5, -5.0, -2.5),
                    opacities=gt.opacities + 2.0)
    cams = orbit_cameras(views, hw, hw, device="cpu")
    with torch.no_grad():
        imgs = render_images(gt, cams, torch.zeros(3), RASTER)[0]
    return torch.clamp(imgs, 0.0, 1.0), cams


def test_fit_improves_psnr():
    """tests/test_fit_gs.py::test_fit_improves_psnr's fit, torch only."""
    images, cams = _target()
    cfg = tf.FitConfig(
        steps=220, capacity=1024, warmup_steps=40, densify_every=40,
        densify_stop=160, reset_opacity_every=0, sh_degree=1,
        sh_degree_interval=60, densify_budget_frac=0.05,
        lr_means=2e-3, lr_means_final=2e-4)
    state0 = tf.init_state(cfg, n_init=256, seed=0, device="cpu")
    before = tf.eval_fit(tf._scene({k: p.detach() for k, p in
                                    state0.params.items()}, state0.mask),
                         images, cams, RASTER)
    scene, metrics = tf.fit_gaussians(images, cams, cfg, RASTER, seed=0)
    after = tf.eval_fit(scene, images, cams, RASTER)
    assert np.isfinite(metrics["loss"])
    assert after["psnr"] > before["psnr"] + 4.0, (before, after)
    assert after["psnr"] > 18.0, (before, after)
    assert scene.means.shape == (cfg.capacity, 3)
    assert 0 < metrics["n_gauss"] == int(scene.mask.sum()) <= cfg.capacity
    for k in tf.ATTRS:
        assert bool(torch.isfinite(getattr(scene, k)).all()), k


def test_opacity_reset():
    cfg = tf.FitConfig(capacity=128, steps=10)
    state = tf.init_state(cfg, n_init=32, seed=2, device="cpu")
    with torch.no_grad():
        state.params["opacities"].fill_(3.0)
    tf.reset_opacities(state, value=0.01)
    assert float(torch.sigmoid(state.params["opacities"].detach()).max()) <= 0.0101
