"""A tiny FeaturePredictor with the JAX package's block-pooling and ALGM
merge configs (model_ptv3_{patch,wpatch,algm}) against the JAX package's
on the CPU, as tests/test_torch_merge_model.py holds the bipartite ones:
every refined attribute within 1e-4, the eval step's PSNR within 1e-3 dB
and SSIM within 1e-4."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_merge_model import check_merge_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["patch", "wpatch", "algm"])
def test_merge_config_matches_jax(name):
    """model_ptv3_<name>'s additional_info (tome_attention and tome_mlp on,
    the config's rate and stride, wpatch's low_r, ALGM's threshold)."""
    check_merge_config(name)
