"""The port's input downsampling (splatformer_tpu_torch/ops/downsample.py)
against the JAX package's ops/downsample.py on the CPU: farthest-point
sampling, the 1-NN assignment, voxel pooling (with and without overflow
into the waste bucket) and random keep with the JAX package's draws
injected. Indices (centroids, assignments, kept points) are identical;
coordinates, features and the map-back within 1e-6 of their largest
magnitude.

FPS's dispatch: CPU tensors take the plain loop, CUDA tensors the F1
kernel (kernels/fps.py) or an error. The card tests hold the kernel's picks
to the plain loop's on the card, bit for bit. JAX is imported by the tests
that compare with it (the ``jx`` fixture), so that the card's machine,
which has no JAX, runs the card tests:

    python -m pytest tests/test_torch_downsample.py -m cuda --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.data.synthetic import random_scene  # noqa: E402
from splatformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from splatformer_tpu_torch.kernels import fps as fps_kernel  # noqa: E402
from splatformer_tpu_torch.ops import downsample as td  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """(jax, the JAX package's ops/downsample.py)."""
    jax = pytest.importorskip("jax")
    from splatformer_tpu.ops import downsample as jd
    return jax, jd


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N, N_VALID = 1024, 1000


def cloud(seed=0):
    """(coord, feat, mask): 1,000 valid points in the unit cube, two of them
    coincident, 24 masked zero slots."""
    rng = np.random.default_rng(seed)
    coord = rng.uniform(size=(N, 3)).astype(np.float32)
    coord[17] = coord[3]
    feat = rng.normal(size=(N, 8)).astype(np.float32)
    coord[N_VALID:] = 0.0
    feat[N_VALID:] = 0.0
    return coord, feat, np.arange(N) < N_VALID


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


@pytest.mark.parametrize("ratio", [0.9, 0.35])
def test_fps_centroids_and_assignment(ratio, jx):
    jax, jd = jx
    coord, feat, mask = cloud()
    m_req = int(N * ratio)
    ref = np.asarray(jax.jit(jd.furthest_point_sampling, static_argnums=2)(
        coord, mask, m_req))
    got = td.furthest_point_sampling(T(coord), T(mask), m_req)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not (got[:N_VALID] >= N_VALID).any()  # masked never chosen

    jref = jax.jit(jd.fps_knn_downsample, static_argnums=3)(
        coord, feat, mask, ratio)
    tgot = td.fps_knn_downsample(T(coord), T(feat), T(mask), ratio)
    np.testing.assert_array_equal(tgot[3].numpy(), np.asarray(jref[3]))
    np.testing.assert_array_equal(tgot[2].numpy(), np.asarray(jref[2]))
    close(tgot[0], jref[0], "coord")
    close(tgot[1], jref[1], "feat")


@pytest.mark.parametrize("voxel_size,capacity", [(0.1, 0.5), (0.05, 0.25)])
def test_voxel_pooling(voxel_size, capacity, jx):
    """At 0.05 the ~960 occupied voxels overflow the 256 slots, so most
    points land in the waste bucket, as in the JAX package."""
    jax, jd = jx
    coord, feat, mask = cloud(1)
    jref = jax.jit(jd.voxel_downsample, static_argnums=(3, 4))(
        coord, feat, mask, voxel_size, capacity)
    tgot = td.voxel_downsample(T(coord), T(feat), T(mask), voxel_size,
                               capacity)
    for i, name in ((2, "mask"), (3, "assign")):
        np.testing.assert_array_equal(tgot[i].numpy(), np.asarray(jref[i]),
                                      err_msg=name)
    close(tgot[0], jref[0], "coord")
    close(tgot[1], jref[1], "feat")
    waste = int((tgot[3] == tgot[0].shape[0]).sum())
    assert (waste > N_VALID // 2) == (voxel_size == 0.05)


def test_nearest_idx(jx):
    jax, jd = jx
    coord, _, mask = cloud(2)
    refs = coord[:300:3]
    ref_mask = np.arange(100) < 90
    ref = jax.jit(jd.nearest_idx)(coord, refs, ref_mask)
    got = td.nearest_idx(T(coord), T(refs), T(ref_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.max()) < 90


@pytest.mark.parametrize("method,info", [
    ("fps", {"downsample_ratio": 0.35}),
    ("voxel", {"voxel_size": 0.1, "voxel_capacity_factor": 0.5}),
    ("random", {"downsample_ratio": 0.6})])
def test_dispatch_and_map_back(method, info, jx):
    """downsample_dispatch and its map-back of the backbone's outputs; for
    random, the port's scores are the JAX package's draws of one key."""
    jax, jd = jx
    coord, feat, mask = cloud(3)
    key = jax.random.key(5)
    scores = np.asarray(jax.random.uniform(key, (N,)))

    def jax_side(coord, feat, mask, y):
        c, f, m, up = jd.downsample_dispatch(method, info, coord, feat, mask,
                                             rng=key)
        return c, f, m, up(y[:c.shape[0]])
    y = np.random.default_rng(4).normal(size=(N, 5)).astype(np.float32)
    jref = jax.jit(jax_side)(coord, feat, mask, y)
    c, f, m, up = td.downsample_dispatch(method, info, T(coord), T(feat),
                                         T(mask), lambda shape: T(scores))
    got = (c, f, m, up(T(y[:c.shape[0]])))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jref[2]))
    for name, g, r in zip(("coord", "feat", "", "map-back"), got, jref):
        if name:
            close(g, r, name)


def test_random_draws_in_evaluation_are_seeded():
    """Without draws, random keep takes a CPU generator seeded 0: the same
    subset on every call (and every device)."""
    coord, feat, mask = (T(a) for a in cloud(5))
    info = {"downsample_ratio": 0.5}
    a = td.downsample_dispatch("random", info, coord, feat, mask)
    b = td.downsample_dispatch("random", info, coord, feat, mask)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    scores = torch.rand(N, generator=torch.Generator().manual_seed(0))
    c = td.downsample_dispatch("random", info, coord, feat, mask,
                               lambda shape: scores)
    np.testing.assert_array_equal(a[0].numpy(), c[0].numpy())


def test_fps_on_cpu_takes_the_plain_loop(monkeypatch):
    """A CPU tensor goes to the plain loop, and the kernel's launch count
    stays put."""
    coord, _, mask = cloud(6)
    calls = []
    plain = td.furthest_point_sampling_plain
    monkeypatch.setattr(td, "furthest_point_sampling_plain",
                        lambda *a: calls.append(a) or plain(*a))
    before = LAUNCHES["fps"]
    got = td.furthest_point_sampling(T(coord), T(mask), 300)
    assert len(calls) == 1 and LAUNCHES["fps"] == before
    assert torch.equal(got, plain(T(coord), T(mask), 300))


@pytest.mark.parametrize("bad", ["cpu", "float64", "mask_int", "mask_short"])
def test_fps_kernel_refuses_what_it_does_not_take(bad):
    """The kernel's wrapper raises before it builds or launches anything:
    on CPU tensors, and on a dtype or shape it does not take (checked on
    CPU tensors here, the device check first)."""
    coord, _, mask = (T(a) for a in cloud(7))
    if bad == "float64":
        coord = coord.double()
    elif bad == "mask_int":
        mask = mask.to(torch.int32)
    elif bad == "mask_short":
        mask = mask[:-1]
    before = LAUNCHES["fps"]
    with pytest.raises(ValueError):
        fps_kernel.furthest_point_sampling_kernel(coord, mask, 10)
    assert LAUNCHES["fps"] == before
    assert fps_kernel.MAX_POINTS == 16 * 1024 * 8 >= 100_352


# ---------------------------------------------------------------------------
# the F1 kernel on the card against the plain loop on the card
# ---------------------------------------------------------------------------

SLOTS, RATIO = 100_352, 0.35   # ptv3_fps's pad and ratio: 35,123 picks


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _same_picks(coord, mask, m):
    got = td.furthest_point_sampling(coord, mask, m)
    want = td.furthest_point_sampling_plain(coord, mask, m)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (m,)
    differ = torch.nonzero(got != want)[:, 0]
    assert differ.numel() == 0, (f"{differ.numel()} of {m} picks differ, "
                                 f"first at {differ[:5].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("live", [50_000, 100_000])
@pytest.mark.parametrize("seed", range(5))
def test_fps_kernel_equals_the_plain_loop_on_card(live, seed):
    _card()
    scene = random_scene(np.random.default_rng(seed), SLOTS, n_valid=live,
                         device="cuda")
    _same_picks(scene.means, scene.mask, int(SLOTS * RATIO))


@pytest.mark.cuda
def test_fps_kernel_on_ties_on_card():
    """Coordinates on a grid of 8^3 cells, so distances tie everywhere and
    most points have duplicates; a tenth of the slots masked at random."""
    _card()
    rng = np.random.default_rng(11)
    coord = torch.as_tensor(rng.integers(0, 8, (SLOTS, 3)) / 8.0,
                            dtype=torch.float32, device="cuda")
    mask = torch.as_tensor(rng.uniform(size=SLOTS) < 0.9, device="cuda")
    _same_picks(coord, mask, int(SLOTS * RATIO))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [70_001, 1_000])
def test_fps_kernel_ragged_n_and_extreme_m_on_card(n):
    """N no multiple of the CTA's 1024 threads, m = 1 and m = the live
    count (every live point picked, the last picks' distances all 0)."""
    _card()
    scene = random_scene(np.random.default_rng(n), n, n_valid=n - n // 10,
                         device="cuda")
    live = int(scene.mask.sum())
    for m in (1, live):
        _same_picks(scene.means, scene.mask, m)


@pytest.mark.cuda
def test_fps_kernel_refuses_past_its_limit_on_card():
    _card()
    n = fps_kernel.MAX_POINTS + 1
    coord = torch.zeros((n, 3), device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    before = LAUNCHES["fps"]
    with pytest.raises(ValueError, match=str(fps_kernel.MAX_POINTS)):
        td.furthest_point_sampling(coord, mask, 5)
    assert LAUNCHES["fps"] == before


@pytest.mark.cuda
def test_fps_on_card_never_runs_the_plain_loop(monkeypatch):
    """fps_knn_downsample on CUDA tensors launches the kernel once and
    never reaches the Python loop."""
    _card()

    def refuse(*args):
        raise AssertionError("the plain loop ran on CUDA tensors")
    monkeypatch.setattr(td, "furthest_point_sampling_plain", refuse)
    scene = random_scene(np.random.default_rng(3), 20_000, n_valid=19_000,
                         device="cuda")
    before = LAUNCHES["fps"]
    td.fps_knn_downsample(scene.means, scene.features_dc, scene.mask, RATIO)
    torch.cuda.synchronize()
    assert LAUNCHES["fps"] == before + 1
