"""The port's Gaussian-sharded render (parallel/gauss_shard.py) against the
JAX package's ``render_images_gauss_sharded`` on its 8-device CPU mesh
(tests/test_gauss_shard.py's settings): ``LocalShards`` at G = 2 and 8,
forward, gradients at G = 8, and tile rows that do not divide over the
shards; and the exchange over 2 gloo processes equal exactly to
``LocalShards(2)`` (the exchange is a copy). JAX is imported inside the
tests only (the spawned processes never load it)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from test_torch_parallel_dp import n, run_gloo  # noqa: E402

ATTRS = ("means", "scales", "quats", "opacities", "features_dc")
FIELDS = ATTRS + ("features_rest", "mask")
BACKGROUND = (0.1, 0.2, 0.3)
RASTER = dict(max_intersects=2 ** 14, tiles_per_gauss=32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    k = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(k)


def scene_arrays(seed, count):
    """A scene as numpy arrays, from the stream that the JAX package's
    random_scene and the port's copy of it share."""
    from splatformer_tpu_torch.data.synthetic import random_scene
    s = random_scene(np.random.default_rng(seed), count, 1, device="cpu")
    return {k: n(getattr(s, k)) for k in FIELDS}


def port_render(arrays, views, hw, gauss, grad_of_mean_square=False):
    """rgb, alpha (and the gradients of mean(rgb^2) by ATTRS) of the
    port's sharded render through ``gauss``."""
    from splatformer_tpu_torch.data.synthetic import orbit_cameras
    from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig
    from splatformer_tpu_torch.parallel.gauss_shard import (
        render_images_gauss_sharded)
    leaves = {k: torch.tensor(v, requires_grad=k in ATTRS)
              for k, v in arrays.items()}
    rgb, alpha = render_images_gauss_sharded(
        GaussianScene(**leaves), orbit_cameras(views, hw, hw, device="cpu"),
        torch.tensor(BACKGROUND), RasterizeConfig(**RASTER), gauss)
    grads = {}
    if grad_of_mean_square:
        torch.mean(torch.square(rgb)).backward()
        grads = {k: n(leaves[k].grad) for k in ATTRS}
    return n(rgb), n(alpha), grads


def jax_render(arrays, views, hw, n_dev, grad_of_mean_square=False):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from splatformer_tpu.data.synthetic import orbit_cameras
    from splatformer_tpu.ops.types import GaussianScene, RasterizeConfig
    from splatformer_tpu.parallel.gauss_shard import (
        render_images_gauss_sharded)
    scene = GaussianScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    cams = orbit_cameras(views, hw, hw)
    rcfg = RasterizeConfig(max_per_tile=512, use_pallas=False, **RASTER)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("gauss",))

    def render(p):
        return render_images_gauss_sharded(
            scene.replace(**p), cams, jnp.asarray(BACKGROUND), rcfg, mesh)
    p = {k: getattr(scene, k) for k in ATTRS}
    rgb, alpha = jax.jit(render)(p)
    grads = {}
    if grad_of_mean_square:
        grads = jax.jit(jax.grad(
            lambda q: jnp.mean(jnp.square(render(q)[0]))))(p)
    return np.asarray(rgb), np.asarray(alpha), jax.device_get(grads)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_local_shards_forward_matches_jax(n_dev):
    """1,024 Gaussians, 2 views at 64^2: rgb and alpha within the JAX
    test's 2e-5 (the same entries per tile in the same order; the two
    frameworks' compositing arithmetic rounds alike up to the order of a
    few float32 sums)."""
    from splatformer_tpu_torch.parallel.gauss_shard import LocalShards
    arrays = scene_arrays(0, 1024)
    rgb, alpha, _ = port_render(arrays, 2, 64, LocalShards(n_dev))
    jrgb, jalpha, _ = jax_render(arrays, 2, 64, n_dev)
    assert rgb.shape == jrgb.shape and alpha.shape == jalpha.shape
    np.testing.assert_allclose(rgb, jrgb, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(alpha, jalpha, atol=2e-5, rtol=1e-4)


def test_local_shards_gradients_match_jax():
    """512 Gaussians, one view at 48^2, 8 shards: the gradient of
    mean(rgb^2) by every attribute within 1e-5 absolute or 5e-3 relative
    of the JAX package's (tests/test_gauss_shard.py's row-block bound)."""
    from splatformer_tpu_torch.parallel.gauss_shard import LocalShards
    arrays = scene_arrays(1, 512)
    _, _, grads = port_render(arrays, 1, 48, LocalShards(8), True)
    _, _, jgrads = jax_render(arrays, 1, 48, 8, True)
    for k in ATTRS:
        assert np.abs(jgrads[k]).max() > 0, k
        np.testing.assert_allclose(grads[k], np.asarray(jgrads[k]),
                                   atol=1e-5, rtol=5e-3, err_msg=k)


def test_local_shards_nondivisible_tile_rows():
    """80^2: 5 tile rows over 8 shards, so that most destinations own one
    row and three own none: the image as the JAX package's within 2e-5,
    and equal to the port's unsharded render within 1e-6."""
    from splatformer_tpu_torch.data.synthetic import orbit_cameras
    from splatformer_tpu_torch.ops.render import render_images
    from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig
    from splatformer_tpu_torch.parallel.gauss_shard import LocalShards
    arrays = scene_arrays(2, 512)
    rgb, _, _ = port_render(arrays, 1, 80, LocalShards(8))
    jrgb, _, _ = jax_render(arrays, 1, 80, 8)
    assert rgb.shape == (1, 80, 80, 3)
    np.testing.assert_allclose(rgb, jrgb, atol=2e-5, rtol=1e-4)
    ref, _ = render_images(
        GaussianScene(**{k: torch.tensor(v) for k, v in arrays.items()}),
        orbit_cameras(1, 80, 80, device="cpu"), torch.tensor(BACKGROUND),
        RasterizeConfig(**RASTER))
    np.testing.assert_allclose(rgb, n(ref), atol=1e-6)


def _gloo_render_worker(rank, world, out):
    rgb, alpha, grads = port_render(
        dict(np.load(os.path.join(out, "scene.npz"))), 2, 48,
        dist.group.WORLD, True)
    # each process's gradient is its own shard's rows: their sum over the
    # processes is the whole scene's
    for k in ATTRS:
        g = torch.tensor(grads[k])
        dist.all_reduce(g)
        grads[k] = n(g)
    np.savez(os.path.join(out, f"render.rank{rank}.npz"), rgb=rgb,
             alpha=alpha, **grads)


def test_gloo_exchange_equals_local_shards(tmp_path):
    """2 processes, one shard each, exchanging through AllToAll over gloo:
    on both processes the whole image, and the gradient of mean(rgb^2)
    summed over the processes, bit-identical to LocalShards(2) in one
    process."""
    from splatformer_tpu_torch.parallel.gauss_shard import LocalShards
    arrays = scene_arrays(3, 512)
    np.savez(tmp_path / "scene.npz", **arrays)
    run_gloo(_gloo_render_worker, 2, tmp_path)
    rgb, alpha, grads = port_render(arrays, 2, 48, LocalShards(2), True)
    for r in range(2):
        got = np.load(tmp_path / f"render.rank{r}.npz")
        assert np.array_equal(got["rgb"], rgb)
        assert np.array_equal(got["alpha"], alpha)
        for k in ATTRS:
            assert np.array_equal(got[k], grads[k]), k
