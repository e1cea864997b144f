"""Parity of the PyTorch port's ops with the JAX package on the CPU: camera,
SH, activation, projection, binning, serialization, segment ops, sparse conv.
The same numpy inputs go through both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.data.synthetic import random_scene as jax_scene  # noqa: E402
from splatformer_tpu.ops import binning as jbin  # noqa: E402
from splatformer_tpu.ops import camera as jcam  # noqa: E402
from splatformer_tpu.ops import projection as jproj  # noqa: E402
from splatformer_tpu.ops import render as jrender  # noqa: E402
from splatformer_tpu.ops import segment_ops as jseg  # noqa: E402
from splatformer_tpu.ops import serialization as jser  # noqa: E402
from splatformer_tpu.ops import sh as jsh  # noqa: E402
from splatformer_tpu.ops import sparse_conv as jconv  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.ops import binning as tbin  # noqa: E402
from splatformer_tpu_torch.ops import camera as tcam  # noqa: E402
from splatformer_tpu_torch.ops import projection as tproj  # noqa: E402
from splatformer_tpu_torch.ops import render as trender  # noqa: E402
from splatformer_tpu_torch.ops import segment_ops as tseg  # noqa: E402
from splatformer_tpu_torch.ops import serialization as tser  # noqa: E402
from splatformer_tpu_torch.ops import sh as tsh  # noqa: E402
from splatformer_tpu_torch.ops import sparse_conv as tconv  # noqa: E402


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def close(a, b, atol):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)


def equal(a, b):
    np.testing.assert_array_equal(n(a), n(b))


@pytest.fixture(scope="module")
def scenes():
    """The same 256-Gaussian scene (230 valid) for both packages."""
    return (jax_scene(np.random.default_rng(3), 256, sh_degree=1, n_valid=230),
            random_scene(np.random.default_rng(3), 256, sh_degree=1,
                         n_valid=230, device="cpu"))


def test_camera_math(rng):
    c2w = np.asarray(jax_orbit(3, 32, 32).c2w)
    for i in range(3):
        close(tcam.opengl_c2w_to_opencv_w2c(t(c2w[i])),
              jcam.opengl_c2w_to_opencv_w2c(jnp.asarray(c2w[i])), 1e-6)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[5] = 0.0  # degenerate -> fallback
    close(tcam.normalize_quats(t(q)), jcam.normalize_quats(jnp.asarray(q)),
          1e-6)
    qn = np.asarray(jcam.normalize_quats(jnp.asarray(q)))
    close(tcam.quat_to_rotmat(t(qn)), jcam.quat_to_rotmat(jnp.asarray(qn)),
          1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh(rng, degree):
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(128, (degree + 1) ** 2, 3)).astype(np.float32)
    close(tsh.eval_sh(degree, t(d), t(coeffs)),
          jsh.eval_sh(degree, jnp.asarray(d), jnp.asarray(coeffs)), 1e-6)


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_activation_and_colors(sh_degree):
    js = jax_scene(np.random.default_rng(5), 128, sh_degree=sh_degree)
    ts = random_scene(np.random.default_rng(5), 128, sh_degree=sh_degree,
                      device="cpu")
    campos = np.asarray(js.means[7])  # one Gaussian exactly at the camera
    ja, ta = jrender.activate_gaussians(js), trender.activate_gaussians(ts)
    for k in ("means", "scales", "quats", "opacities"):
        close(ta[k], ja[k], 1e-6)
    cj = jrender.compute_colors(js, jnp.asarray(campos))
    ct = trender.compute_colors(ts, t(campos))
    close(ct, cj, 1e-6)


def _project_both(js, ts, cam_j, cam_t, i, h, w):
    ja, ta = jrender.activate_gaussians(js), trender.activate_gaussians(ts)
    mj = js.valid_mask()
    op_j = jnp.where(mj, ja["opacities"], 0.0)
    op_t = torch.where(ts.valid_mask(), ta["opacities"], 0.0)
    pj = jproj.project_gaussians(
        ja["means"], ja["scales"], ja["quats"],
        jcam.opengl_c2w_to_opencv_w2c(cam_j.c2w[i]),
        cam_j.fx[i], cam_j.fy[i], cam_j.cx[i], cam_j.cy[i], h, w,
        mask=mj, opacities=op_j)
    pt = tproj.project_gaussians(
        ta["means"], ta["scales"], ta["quats"],
        tcam.opengl_c2w_to_opencv_w2c(cam_t.c2w[i]),
        cam_t.fx[i], cam_t.fy[i], cam_t.cx[i], cam_t.cy[i], h, w,
        mask=ts.valid_mask(), opacities=op_t)
    return pj, pt


@pytest.mark.parametrize("view", [0, 1, 2])
def test_projection(scenes, view):
    js, ts = scenes
    cj, ct = jax_orbit(3, 48, 40), orbit_cameras(3, 48, 40, device="cpu")
    pj, pt = _project_both(js, ts, cj, ct, view, 48, 40)
    live = n(pj.radii) > 0
    assert live.sum() > 50
    for k in ("xys", "conics"):
        close(getattr(pt, k)[live], n(getattr(pj, k))[live], 1e-5)
    close(pt.depths, pj.depths, 1e-5)
    equal(pt.radii, pj.radii)
    equal(pt.num_tiles_hit, pj.num_tiles_hit)
    equal(pt.radii_xy, pj.radii_xy)


def _jax_proj_to_torch(pj):
    return tproj.ProjectedGaussians(
        **{k: t(getattr(pj, k)) for k in tproj.ProjectedGaussians._fields})


def _assert_bins_equal(bt, bj):
    for k in ("gauss_idx", "tile_ids", "tile_start", "num_entries",
              "num_dropped", "gauss_starts"):
        equal(getattr(bt, k), getattr(bj, k))


@pytest.mark.parametrize("budget,tpg", [(2 ** 12, 16), (96, 16), (2 ** 12, 64)])
def test_binning_single_view(scenes, budget, tpg):
    js, ts = scenes
    cj = jax_orbit(2, 48, 40)
    pj, _ = _project_both(js, ts, cj, orbit_cameras(2, 48, 40, device="cpu"),
                          0, 48, 40)
    bj = jbin.bin_gaussians(pj, 48, 40, 16, budget, tpg)
    bt = tbin.bin_gaussians(_jax_proj_to_torch(pj), 48, 40, 16, budget, tpg)
    _assert_bins_equal(bt, bj)
    if budget < 100:
        assert int(bt.num_dropped) > 0  # the over-budget case really drops


def test_binning_equal_depth_ties(scenes):
    """Equal depths must keep Gaussian-id order; tiny tiers force the tiered
    expansion (and its drops) too."""
    js, ts = scenes
    cj = jax_orbit(1, 64, 64)
    pj, _ = _project_both(js, ts, cj, orbit_cameras(1, 64, 64, device="cpu"),
                          0, 64, 64)
    depths = np.asarray(pj.depths).copy()
    finite = np.isfinite(depths)
    depths[finite] = np.round(depths[finite] * 4) / 4  # heavy ties
    pj = pj._replace(depths=jnp.asarray(depths))
    for tiers in (None, (1, 8, 2, 4)):
        bj = jbin.bin_gaussians(pj, 64, 64, 16, 2 ** 12, 16, tiers=tiers)
        bt = tbin.bin_gaussians(_jax_proj_to_torch(pj), 64, 64, 16, 2 ** 12,
                                16, tiers=tiers)
        _assert_bins_equal(bt, bj)


def test_depth_key(rng):
    d = rng.uniform(0.0, 10.0, 256).astype(np.float32)
    d[:4] = [np.inf, np.nan, -1.0, 0.0]
    equal(tbin.depth_key_i32(t(d)), jbin.depth_key_i32(jnp.asarray(d)))


def test_serialization_codes_and_orders(rng):
    grid = rng.integers(0, 384, (512, 3)).astype(np.int32)
    grid[10:20] = grid[0]  # duplicates: order must be stable in index
    mask = np.arange(512) < 480
    for order in tser.ORDERS:
        equal(tser.encode(t(grid), order), jser.encode(jnp.asarray(grid), order))
    ct, ot, it = tser.serialize(t(grid), t(mask))
    cj, oj, ij = jser.serialize(jnp.asarray(grid), jnp.asarray(mask))
    equal(ct, cj)
    equal(ot, oj)
    equal(it, ij)


def test_segment_ops(rng):
    data = rng.normal(size=(200, 5)).astype(np.float32)
    ids = rng.integers(0, 17, 200).astype(np.int32)
    ids[ids == 3] = 4  # an empty segment
    for tf, jf in ((tseg.segment_sum, jseg.segment_sum),
                   (tseg.segment_max, jseg.segment_max),
                   (tseg.segment_mean, jseg.segment_mean)):
        close(tf(t(data), t(ids), 17), jf(jnp.asarray(data), jnp.asarray(ids),
                                          17), 1e-5)


@pytest.mark.parametrize("n_valid", [64, 200, 256])
def test_pad_order_for_patches(rng, n_valid):
    perm = rng.permutation(256).astype(np.int32)
    equal(tseg.pad_order_for_patches(t(perm), torch.tensor(n_valid), 48),
          jseg.pad_order_for_patches(jnp.asarray(perm), jnp.int32(n_valid), 48))


@pytest.mark.parametrize("span", [4, 32])
def test_neighbor_map_and_conv(rng, span):
    """Exact neighbour map (including multi-occupant voxels, masked points
    and the grid edge) and conv output within 1e-5."""
    nn_, c, cout = 160, 8, 6
    grid = rng.integers(0, span, (nn_, 3)).astype(np.int32)
    grid[0] = [0, 0, 1023]
    mask = np.arange(nn_) < 140
    equal(tconv.build_neighbor_map(t(grid), t(mask)),
          jconv.build_neighbor_map(jnp.asarray(grid), jnp.asarray(mask)).nbr)
    feat = rng.normal(size=(nn_, c)).astype(np.float32)
    w = (rng.normal(size=(27, c, cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    cs = jconv.build_neighbor_map(jnp.asarray(grid), jnp.asarray(mask))
    out_j = jconv.sparse_conv_apply(jnp.asarray(feat), cs, jnp.asarray(w),
                                    jnp.asarray(b))
    out_t = tconv.sparse_conv_apply(t(feat), tconv.build_neighbor_map(
        t(grid), t(mask)), t(w), t(b))
    close(out_t, out_j, 1e-5)
