"""One SGD train step of a tiny FeaturePredictor with random input
downsampling (model_ptv3_drop) against the JAX package's make_train_step,
the random scores injected into the port as the JAX package's draws
(tests/test_torch_merge_train.py's comparison and tolerances): gradients
reach the backbone through the map-back of the reduced set."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_merge_train import check_train_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_drop_train_step_matches_jax(monkeypatch):
    check_train_step(monkeypatch, "drop")
