"""Parity of the port's render path with the JAX package on the CPU: the K1
compositor's plain version against the Pallas kernel (interpret mode) on
the same packed entries, and the whole flat multi-view render. The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.data.synthetic import random_scene as jax_scene  # noqa: E402
from splatformer_tpu.ops.pallas.raster import composite_packed as jax_composite  # noqa: E402
from splatformer_tpu.ops.render import render_images_stats as jax_render  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from splatformer_tpu_torch.kernels.composite import (composite_fwd,  # noqa: E402
                                                     composite_fwd_plain)
from splatformer_tpu_torch.ops.raster import composite_packed  # noqa: E402
from splatformer_tpu_torch.ops.render import (prepare_entries,  # noqa: E402
                                              render_images_stats)
from splatformer_tpu_torch.ops.types import RasterizeConfig  # noqa: E402

BG = (0.3, 0.1, 0.2)


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def setup():
    """256 Gaussians (230 valid), 2 views at 32^2, for both packages."""
    scene = random_scene(np.random.default_rng(3), 256, sh_degree=1,
                         n_valid=230, device="cpu")
    cams = orbit_cameras(2, 32, 32, device="cpu")
    cfg = RasterizeConfig(max_intersects=2 ** 12, tiles_per_gauss=16)
    return scene, cams, cfg


def test_composite_plain_matches_pallas(setup):
    """K1's plain version vs the Pallas fwd_kernel on the same entries."""
    scene, cams, cfg = setup
    e = prepare_entries(scene, cams, cfg)
    bg = torch.tensor(BG)
    rgb_t, al_t = composite_packed(e.packed_t, e.tile_start, 32, 32, 16, bg,
                                   num_images=2)
    rgb_j, al_j = jax_composite(jnp.asarray(n(e.packed_t)),
                                jnp.asarray(n(e.tile_start)), 32, 32, 16,
                                jnp.asarray(BG), interpret=True, num_images=2)
    np.testing.assert_allclose(n(rgb_t), n(rgb_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(al_t), n(al_j), rtol=0, atol=1e-5)
    assert float(al_t.max()) > 0.5  # the scene really covers pixels


def _walk_reference(packed, tile_start, tiles_x, tiles_img, athr=1 / 255,
                    amax=0.999, eps=1e-4):
    """Per-pixel sequential walk in float32 numpy: the kernel's contract
    written out, including the walked-entry count."""
    f = np.float32
    num_tiles = len(tile_start) - 1
    out = np.zeros((num_tiles, 256, 4), np.float32)
    walked = np.zeros((num_tiles, 256), np.int32)
    for tile in range(num_tiles):
        local = tile % tiles_img
        s, e = tile_start[tile], tile_start[tile + 1]
        for p in range(256):
            px = f((local % tiles_x) * 16 + p % 16)
            py = f((local // tiles_x) * 16 + p // 16)
            rgb, T, k = np.zeros(3, np.float32), f(1.0), 0
            for j in range(s, e):
                x, y, c0, c1, c2, op = packed[:6, j]
                dx, dy = x - px, y - py
                sig = max(f(0.5) * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy,
                          f(0.0))
                a = min(f(amax), op * np.exp(-sig))
                if a < f(athr):
                    k += 1
                    continue
                nt = T * (f(1.0) - a)
                if nt <= f(eps):
                    break
                rgb = rgb + (a * T) * packed[6:9, j]
                T, k = nt, k + 1
            out[tile, p, :3], out[tile, p, 3], walked[tile, p] = rgb, T, k
    return out, walked


def test_composite_plain_walked_counts(setup):
    """The plain version (chunked walk) vs a per-pixel sequential walk:
    outputs within 1e-6 and the walked-entry counts exact."""
    _, cams, cfg = setup
    # larger, nearly opaque splats so that pixels terminate mid-range
    scene = random_scene(np.random.default_rng(11), 384, sh_degree=1,
                         device="cpu")
    scene = scene.replace(scales=scene.scales + 1.5,
                          opacities=torch.full_like(scene.opacities, 4.0))
    e = prepare_entries(scene, cams.replace(c2w=cams.c2w[:1], fx=cams.fx[:1],
                                            fy=cams.fy[:1], cx=cams.cx[:1],
                                            cy=cams.cy[:1]), cfg)
    out, walked = composite_fwd_plain(e.packed_t, e.tile_start, 2, 4)
    ref_out, ref_walked = _walk_reference(n(e.packed_t), n(e.tile_start), 2, 4)
    np.testing.assert_allclose(n(out), ref_out, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(walked), ref_walked)
    assert (ref_walked < np.diff(n(e.tile_start))[:, None]).any()  # breaks


@pytest.mark.parametrize("max_intersects", [2 ** 12, 128])
def test_render_images_stats_matches_jax(setup, max_intersects):
    """The whole flat multi-view render against the JAX package's Pallas
    path (interpret mode), with an ample and an over-budget intersect cap."""
    scene, cams, _ = setup
    cfg = RasterizeConfig(max_intersects=max_intersects, tiles_per_gauss=16)
    jcfg = JaxConfig(max_intersects=max_intersects, tiles_per_gauss=16,
                     use_pallas=True)
    jscene = jax_scene(np.random.default_rng(3), 256, sh_degree=1, n_valid=230)
    rgb_j, al_j, st_j = jax_render(jscene, jax_orbit(2, 32, 32),
                                   jnp.asarray(BG), jcfg)
    rgb_t, al_t, st_t = render_images_stats(scene, cams, torch.tensor(BG), cfg)
    np.testing.assert_allclose(n(rgb_t), n(rgb_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(al_t), n(al_j), rtol=0, atol=1e-5)
    for k in ("num_dropped", "num_entries"):
        assert int(st_t[k]) == int(st_j[k]), k
    assert (int(st_t["num_dropped"]) > 0) == (max_intersects < 1000)


def test_composite_wrapper_devices(setup):
    """CPU tensors take the plain version without counting a launch; a
    device with no kernel raises instead of falling back."""
    scene, cams, cfg = setup
    e = prepare_entries(scene, cams, cfg)
    before = LAUNCHES["composite_fwd"]
    out, walked = composite_fwd(e.packed_t, e.tile_start, 2, 4)
    assert LAUNCHES["composite_fwd"] == before
    assert out.shape == (8, 256, 4) and walked.dtype == torch.int32
    with pytest.raises(ValueError):
        composite_fwd(e.packed_t.to("meta"), e.tile_start.to("meta"), 2, 4)
    with pytest.raises(ValueError):
        composite_fwd(e.packed_t, e.tile_start, 3, 4)

