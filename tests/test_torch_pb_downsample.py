"""The port's FPS downsampling against the benchmark's plain reference
(perfbench/reference/downsample.py) on the CPU, bit for bit: FPS is
chaotic (one ulp in a distance can move a pick and every pick after it), so
the reference's arithmetic defines the right picks, and serve_fps holds the
port's picks and assignments to it with a limit of 0 (``assign_mismatch``).
The card runs the same comparison in the benchmark and in
tests/test_torch_downsample.py's card tests (the F1 kernel against the
plain loop)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.reference import downsample as ref  # noqa: E402
from splatformer_tpu_torch.ops import downsample as port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cloud(n: int, n_valid: int, seed: int, grid: int = 0):
    """(coord, feat, mask): n slots, the first n_valid live; uniform in
    [0.05, 0.95]^3, or with ``grid`` on a grid of grid^3 cells, so that
    distances tie and points repeat. Masked slots keep their coordinates:
    they must never be picked."""
    rng = np.random.default_rng(seed)
    if grid:
        coord = rng.integers(0, grid, (n, 3)) / grid
    else:
        coord = rng.uniform(0.05, 0.95, (n, 3))
    feat = rng.normal(size=(n, 5))
    return (torch.as_tensor(coord, dtype=torch.float32),
            torch.as_tensor(feat, dtype=torch.float32),
            torch.arange(n) < n_valid)


CASES = [(4096, 3000, 0, 0), (4096, 4096, 1, 0), (3000, 1111, 2, 0),
         (4096, 3500, 3, 6)]
IDS = ["partial", "full", "ragged", "grid"]


@pytest.mark.parametrize("n,n_valid,seed,grid", CASES, ids=IDS)
def test_fps_picks_equal_the_references(n, n_valid, seed, grid):
    coord, _, mask = cloud(n, n_valid, seed, grid)
    m = int(n * 0.35)
    got = port.furthest_point_sampling(coord, mask, m)
    assert torch.equal(got, ref.furthest_point_sampling(coord, mask, m))
    assert int(got.max()) < n_valid


@pytest.mark.parametrize("n,n_valid,seed,grid", CASES, ids=IDS)
def test_fps_reduced_set_and_assignment_equal_the_references(n, n_valid,
                                                             seed, grid):
    """fps_knn_downsample's reduced set (coordinates, features, mask) and
    each point's cluster, at ratio 0.35 and at 0.9 (more picks than the
    partial cloud's live points)."""
    coord, feat, mask = cloud(n, n_valid, seed, grid)
    for ratio in (0.35, 0.9):
        got = port.fps_knn_downsample(coord, feat, mask, ratio)
        want = ref.fps_knn_downsample(coord, feat, mask, ratio)
        assert got[0].shape[0] == ref.fps_capacity(n, ratio)
        for name, g, w in zip(("coord", "feat", "mask", "assign"), got,
                              want):
            assert torch.equal(g, w), (name, ratio)
