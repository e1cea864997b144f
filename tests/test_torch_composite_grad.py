"""The compositing backward: K2's plain version, reached through the port's
CompositePacked autograd function, against jax.vjp of the JAX package's
composite_packed (its Pallas bwd_kernel in interpret mode) on the same
packed entries. The loss has an alpha term as well as an rgb term, so the
T-channel cotangent is exercised.

Tolerance: each gradient row within 1e-4 of its own largest magnitude (the
TPU kernel steps transmittance in the log domain and evaluates sigma as an
expanded quadratic, the port directly, so they round apart), the
background gradient within 1e-5 relative."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.ops.pallas.raster import composite_packed as jax_composite  # noqa: E402
from splatformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from splatformer_tpu_torch.kernels.composite import (composite_bwd,  # noqa: E402
                                                     composite_fwd)
from splatformer_tpu_torch.ops.raster import composite_packed  # noqa: E402

ROW_TOL = 1e-4


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def ragged_entries(seed, budget=1408, tile_start=(0, 0, 257, 900, 1300),
                   opaque=False):
    """Packed entries of one 32x32 view (2 x 2 tiles): tile 0 empty, ranges
    of 257, 643 and 400 entries (no multiple of 128 or 256), the budget's
    tail past 1300 unused. 10% of the opacities are 1.0, so the max-alpha
    clamp is active at splat centres; with ``opaque`` the splats are
    large and dense, so pixels terminate."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((16, budget), np.float32)
    end = tile_start[-1]
    packed[0:2, :end] = rng.uniform(0, 32, (2, end))
    lo, hi = (0.005, 0.05) if opaque else (0.05, 0.5)
    packed[2, :end] = rng.uniform(lo, hi, end)
    packed[4, :end] = rng.uniform(lo, hi, end)
    packed[3, :end] = rng.uniform(-0.2, 0.2, end) * np.sqrt(
        packed[2, :end] * packed[4, :end])
    packed[5, :end] = rng.uniform(0.5 if opaque else 0.1, 0.95, end)
    packed[5, :end][rng.uniform(size=end) < 0.1] = 1.0
    packed[6:9, :end] = rng.uniform(0, 1, (3, end))
    return packed, np.asarray(tile_start, np.int32)


def grads_both(packed, tile_start, hw, views, bg, seed):
    """(d_packed, d_bg) of sum(w_rgb * rgb) + sum(w_a * alpha) from the port
    (CPU, plain K2) and from JAX."""
    rng = np.random.default_rng(seed)
    w_rgb = rng.normal(size=(views, hw, hw, 3)).astype(np.float32)
    w_a = rng.normal(size=(views, hw, hw)).astype(np.float32)

    def jloss(p, b):
        rgb, alpha = jax_composite(p, jnp.asarray(tile_start), hw, hw, 16, b,
                                   interpret=True, num_images=views)
        return jnp.sum(rgb * w_rgb) + jnp.sum(alpha * w_a)

    gj_p, gj_b = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(packed),
                                                 jnp.asarray(bg))
    p_t = torch.tensor(packed, requires_grad=True)
    b_t = torch.tensor(bg, requires_grad=True)
    rgb, alpha = composite_packed(p_t, torch.from_numpy(tile_start), hw, hw,
                                  16, b_t, num_images=views)
    loss = (rgb * torch.from_numpy(w_rgb)).sum() \
        + (alpha * torch.from_numpy(w_a)).sum()
    loss.backward()
    return (n(p_t.grad), n(b_t.grad)), (np.asarray(gj_p), np.asarray(gj_b))


def assert_rows_close(port, ref):
    for r in range(9):
        scale = max(float(np.abs(ref[r]).max()), 1e-12)
        err = float(np.abs(port[r] - ref[r]).max())
        assert err <= ROW_TOL * scale, (r, err, scale)
    assert not port[9:].any()


def replayed_columns(packed, tile_start, tiles_x, tiles_img):
    """Boolean (budget,) mask of the entry columns that some pixel replays,
    from K1's walked counts."""
    _, walked = composite_fwd(torch.from_numpy(packed),
                              torch.from_numpy(tile_start), tiles_x, tiles_img)
    walked = n(walked)
    mask = np.zeros(packed.shape[1], bool)
    for t in range(len(tile_start) - 1):
        mask[tile_start[t]:tile_start[t] + walked[t].max()] = True
    return mask, walked


@pytest.mark.parametrize("opaque", [False, True], ids=["sparse", "opaque"])
def test_composite_backward_matches_jax(opaque):
    packed, ts = ragged_entries(5, opaque=opaque)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    (gp, gb), (jp, jb) = grads_both(packed, ts, 32, 1, bg, seed=9)
    assert_rows_close(gp, jp)
    np.testing.assert_allclose(gb, jb, rtol=1e-5, atol=1e-5)
    assert np.abs(gp[:9]).max() > 0 and np.abs(gb).max() > 0

    replayed, walked = replayed_columns(packed, ts, 2, 4)
    # outside every replayed range the gradient is exactly zero: the empty
    # tile, the columns behind each tile's longest walk, the unused tail
    assert not gp[:, ~replayed].any()
    assert not gp[:, ts[-1]:].any() and walked[0].max() == 0
    lengths = np.diff(ts)
    terminated = walked < lengths[:, None]
    if opaque:
        assert terminated.any() and (~replayed[:ts[-1]]).any()
    # the max-alpha clamp is active somewhere: an entry at opacity 1.0 and
    # a pixel at its centre has raw >= 0.999
    assert (packed[5, :ts[-1]] >= 0.999).any()


def test_composite_backward_scene_entries():
    """Entries that the port's own binning makes for a scene (2 views at
    32^2), under a white-ish background."""
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    scene = random_scene(np.random.default_rng(3), 256, sh_degree=1,
                         n_valid=230, device="cpu")
    cfg = RasterizeConfig(max_intersects=2 ** 12, tiles_per_gauss=16)
    e = prepare_entries(scene, orbit_cameras(2, 32, 32, device="cpu"), cfg)
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    (gp, gb), (jp, jb) = grads_both(n(e.packed_t), n(e.tile_start), 32, 2,
                                    bg, seed=4)
    assert_rows_close(gp, jp)
    np.testing.assert_allclose(gb, jb, rtol=1e-5, atol=1e-5)


def test_composite_bwd_wrapper_devices():
    """CPU tensors take the plain version without counting a launch; bad
    shapes and devices without a kernel raise."""
    packed, ts = ragged_entries(1)
    p_t, ts_t = torch.from_numpy(packed), torch.from_numpy(ts)
    out, walked = composite_fwd(p_t, ts_t, 2, 4)
    g = torch.ones_like(out)
    before = LAUNCHES["composite_bwd"]
    d = composite_bwd(p_t, ts_t, 2, 4, out, walked, g)
    assert LAUNCHES["composite_bwd"] == before
    assert d.shape == (16, 1408) and d.dtype == torch.float32
    with pytest.raises(ValueError):
        composite_bwd(p_t, ts_t, 2, 4, out, walked, g[:3])
    with pytest.raises(ValueError):
        composite_bwd(p_t.to("meta"), ts_t.to("meta"), 2, 4, out.to("meta"),
                      walked.to("meta"), g.to("meta"))
