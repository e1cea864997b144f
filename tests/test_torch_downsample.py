"""The port's input downsampling (splatformer_tpu_torch/ops/downsample.py)
against the JAX package's ops/downsample.py on the CPU: farthest-point
sampling, the 1-NN assignment, voxel pooling (with and without overflow
into the waste bucket) and random keep with the JAX package's draws
injected. Indices (centroids, assignments, kept points) are identical;
coordinates, features and the map-back within 1e-6 of their largest
magnitude."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from splatformer_tpu.ops import downsample as jd  # noqa: E402
from splatformer_tpu_torch.ops import downsample as td  # noqa: E402


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
def test_fps_centroids_and_assignment(ratio):
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
def test_voxel_pooling(voxel_size, capacity):
    """At 0.05 the ~960 occupied voxels overflow the 256 slots, so most
    points land in the waste bucket, as in the JAX package."""
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


def test_nearest_idx():
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
def test_dispatch_and_map_back(method, info):
    """downsample_dispatch and its map-back of the backbone's outputs; for
    random, the port's scores are the JAX package's draws of one key."""
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
