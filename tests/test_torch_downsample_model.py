"""A tiny FeaturePredictor with each input-downsampling config of the JAX
package (model_ptv3_{fps,voxel,drop}) against the JAX package's on the
CPU, eval mode, same weights (helpers of tests/test_torch_merge_model.py):
the backbone runs on the reduced set, its outputs are mapped back to every
point and the heads see the full-resolution input features. drop's
evaluation draws come from jax.random.key(0) in the JAX package, which the
port cannot reproduce: the same draws are injected. Refined attributes
within 1e-4, PSNR within 1e-3 dB, SSIM within 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_merge_model import TINY, check_config, infos  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["fps", "voxel", "drop"])
def test_downsample_config_matches_jax(name):
    """The config's method and ratio (fps 0.35: 89 centroids in 128 rows;
    voxel 0.0075 at capacity 0.5: 128 rows, the rest of the points in the
    waste bucket; drop 0.6: 153 of 256 kept)."""
    info = infos(f"ptv3_{name}")
    scores = None
    if name == "drop":
        scores = torch.from_numpy(np.array(
            jax.random.uniform(jax.random.key(0), (256,))))
    check_config(info, TINY, TINY, downsample_scores=scores)
