"""The port's raster-budget calibration (ops/calibrate.py) against the JAX
package's on the same samples: the tile counts, the statistics and the
calibrated RasterizeConfig, whose fields are integers and must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.ops import calibrate as jcal  # noqa: E402
from splatformer_tpu.ops.types import GaussianScene as JaxScene  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxRaster  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.ops import calibrate as pcal  # noqa: E402
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest", "mask")
# (seed, slots, live, views, height, width, scale shift): a padded scene,
# a non-square image, and a scene of large splats (log-scales + 2.5) whose
# tile counts reach the tier caps
SAMPLES = [(1, 2048, 2048, 3, 64, 64, 0.0), (2, 3072, 2900, 2, 80, 96, 0.0),
           (3, 1024, 1024, 4, 64, 64, 2.5)]


def samples():
    jax_s, port_s = [], []
    for seed, n, n_valid, views, h, w, shift in SAMPLES:
        scene = random_scene(np.random.default_rng(seed), n, 1, n_valid,
                             device="cpu")
        scene = scene.replace(scales=scene.scales + shift)
        port_s.append((scene, orbit_cameras(views, h, w, device="cpu")))
        jax_s.append((JaxScene(**{k: jnp.asarray(getattr(scene, k).numpy())
                                  for k in FIELDS}),
                      jax_orbit(views, h, w)))
    return jax_s, port_s


def test_tile_counts_and_stats_match():
    jax_s, port_s = samples()
    for (js, jc), (ps, pc) in zip(jax_s, port_s):
        np.testing.assert_array_equal(pcal._tile_counts(ps, pc),
                                      np.asarray(jcal._tile_counts(js, jc)))
    js, ps = jcal.measure_tile_stats(jax_s), pcal.measure_tile_stats(port_s)
    for k in ("max_count", "q99", "q999", "alive_per_view",
              "max_hits_per_view", "mean_hits_per_view"):
        assert ps[k] == js[k], k
    for thr in (1, 4, 16):
        assert ps["exceed_per_view"](thr) == js["exceed_per_view"](thr)


@pytest.mark.parametrize("margin", [2.0, 1.25])
def test_calibrated_config_equals_jax(margin):
    jax_s, port_s = samples()
    j = jcal.calibrate_raster_config(jax_s, JaxRaster(), margin=margin)
    p = pcal.calibrate_raster_config(port_s, RasterizeConfig(), margin=margin)
    assert (p.tiers, p.tiles_per_gauss, p.max_intersects) == (
        tuple(j.tiers), j.tiles_per_gauss, j.max_intersects)
    assert pcal.calibration_summary(p) == jcal.calibration_summary(j)
    # the fields calibration does not size are the base's
    assert (p.tile_size, p.clip_thresh, p.alpha_threshold) == (
        16, 0.01, 1.0 / 255.0)
