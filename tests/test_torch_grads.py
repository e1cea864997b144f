"""The pieces of the port's training path against the JAX package on the
CPU: render gradients, sparse-conv and segment gradients, masked BatchNorm
in train mode, DropPath, order shuffling, the optimizer against optax and
LPIPS. The whole train step is in tests/test_torch_train_step.py. Each
tolerance is stated where it is used."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit  # noqa: E402
from splatformer_tpu.models import layers as jlayers  # noqa: E402
from splatformer_tpu.models import lpips as jlpips  # noqa: E402
from splatformer_tpu.ops import segment_ops as jseg  # noqa: E402
from splatformer_tpu.ops import sparse_conv as jconv  # noqa: E402
from splatformer_tpu.ops.render import render_images_stats as jax_render  # noqa: E402
from splatformer_tpu.ops.types import GaussianScene as JaxScene  # noqa: E402
from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig  # noqa: E402
from splatformer_tpu.training import optim as joptim  # noqa: E402
from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene  # noqa: E402
from splatformer_tpu_torch.models import lpips as tlpips  # noqa: E402
from splatformer_tpu_torch.models.layers import DropPath, MaskedBatchNorm  # noqa: E402
from splatformer_tpu_torch.ops import segment_ops as tseg  # noqa: E402
from splatformer_tpu_torch.ops import sparse_conv as tconv  # noqa: E402
from splatformer_tpu_torch.ops.render import render_images_stats  # noqa: E402
from splatformer_tpu_torch.ops.types import GaussianScene, RasterizeConfig  # noqa: E402
from splatformer_tpu_torch.training.optim import (build_optimizer,  # noqa: E402
                                                  build_schedule)

ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
         "features_rest")
FIELDS = ATTRS + ("mask",)


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def scene_arrays(seed, n_pts=256, n_valid=230):
    """A clean scene and a perturbed copy of it, as dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    clean = {k: n(getattr(random_scene(rng, n_pts, 1, n_valid, device="cpu"),
                          k)) for k in FIELDS}
    noisy = dict(clean)
    noisy["means"] = (clean["means"] + 0.004 * rng.normal(
        size=clean["means"].shape)).astype(np.float32)
    noisy["scales"] = (clean["scales"] + 0.1 * rng.normal(
        size=clean["scales"].shape)).astype(np.float32)
    return clean, noisy


# ---------------------------------------------------------------- render


@pytest.mark.parametrize("max_intersects", [2 ** 12, 128])
def test_render_gradients_match_jax(max_intersects):
    """d(L1 + alpha term)/d(each of the six attributes) of the flat
    multi-view render against jax.grad through the JAX Pallas path
    (interpret mode). With the over-budget cap (128) entries are dropped
    and budget slots resolve to Gaussian 0, whose gradient must stay
    exact. Tolerance: each attribute within 1e-4 of its largest gradient
    magnitude; masked Gaussians exactly 0."""
    _, scene = scene_arrays(3)
    rng = np.random.default_rng(1)
    gt = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    w_a = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    jcfg = JaxConfig(max_intersects=max_intersects, tiles_per_gauss=16,
                     use_pallas=True)
    cams = jax_orbit(2, 32, 32)

    def jloss(attrs):
        s = JaxScene(**attrs, mask=jnp.asarray(scene["mask"]))
        rgb, alpha, st = jax_render(s, cams, jnp.asarray(bg), jcfg)
        return jnp.mean(jnp.abs(rgb - gt)) + jnp.sum(alpha * w_a), st

    jg, jst = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(scene[k]) for k in ATTRS})
    leaves = {k: torch.tensor(scene[k], requires_grad=True) for k in ATTRS}
    s = GaussianScene(**leaves, mask=torch.from_numpy(scene["mask"]))
    rgb, alpha, st = render_images_stats(
        s, orbit_cameras(2, 32, 32, device="cpu"), torch.from_numpy(bg),
        RasterizeConfig(max_intersects=max_intersects, tiles_per_gauss=16))
    loss = torch.mean(torch.abs(rgb - torch.from_numpy(gt))) \
        + torch.sum(alpha * torch.from_numpy(w_a))
    loss.backward()
    assert int(st["num_dropped"]) == int(jst["num_dropped"])
    assert (int(st["num_dropped"]) > 0) == (max_intersects < 1000)
    masked = ~scene["mask"]
    for k in ATTRS:
        g_t, g_j = n(leaves[k].grad), np.asarray(jg[k])
        assert np.isfinite(g_t).all(), k
        scale = float(np.abs(g_j).max())
        assert scale > 0, k
        err = float(np.abs(g_t - g_j).max())
        assert err <= 1e-4 * scale, (k, err, scale)
        assert not g_t[masked].any(), k


# --------------------------------------------------------- ops gradients


def test_sparse_conv_gradients_match_jax():
    """Autograd through the port's gather-matmul against the JAX package's
    scatter-free custom_vjp: several points in one voxel (min-index
    representative), masked points, missing neighbours. Tolerance 1e-5
    relative to each gradient's largest magnitude."""
    rng = np.random.default_rng(2)
    npts, cin, cout = 96, 5, 4
    grid = rng.integers(0, 5, (npts, 3)).astype(np.int32)
    grid[10:16] = grid[3]            # six points share point 3's voxel
    mask = rng.uniform(size=npts) > 0.15
    mask[3] = mask[12] = False       # masked occupants of a shared voxel
    feat = rng.normal(size=(npts, cin)).astype(np.float32)
    weight = rng.normal(size=(27, cin, cout)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    w_out = rng.normal(size=(npts, cout)).astype(np.float32)

    cs = jconv.build_neighbor_map(jnp.asarray(grid), jnp.asarray(mask))
    jg = jax.grad(lambda f, w, b: jnp.sum(
        jconv.sparse_conv_apply(f, cs, w, b) * w_out), argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(weight), jnp.asarray(bias))
    nbr = tconv.build_neighbor_map(torch.from_numpy(grid),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(n(nbr), np.asarray(cs.nbr))
    tf, tw, tb = (torch.tensor(a, requires_grad=True)
                  for a in (feat, weight, bias))
    (tconv.sparse_conv_apply(tf, nbr, tw, tb)
     * torch.from_numpy(w_out)).sum().backward()
    for t, j in zip((tf, tw, tb), jg):
        j = np.asarray(j)
        err = float(np.abs(n(t.grad) - j).max())
        assert err <= 1e-5 * float(np.abs(j).max()), err
    assert not n(tf.grad)[~mask].any()


def test_segment_gradients_match_jax():
    """segment_max with exact ties (split evenly, as JAX's segment_max) and
    an empty segment (the isfinite fill carries no gradient), segment_mean
    and segment_sum; exact."""
    data = np.array([[1., 2.], [1., 3.], [0.5, 3.], [4., 4.], [4., -1.],
                     [2., 2.]], np.float32)
    ids = np.array([0, 0, 0, 2, 2, 3], np.int32)
    w = np.arange(1, 11, dtype=np.float32).reshape(5, 2)
    for jf, tf in ((jseg.segment_max, tseg.segment_max),
                   (jseg.segment_mean, tseg.segment_mean),
                   (jseg.segment_sum, tseg.segment_sum)):
        gj = jax.grad(lambda x: jnp.sum(jf(x, jnp.asarray(ids), 5) * w))(
            jnp.asarray(data))
        x = torch.tensor(data, requires_grad=True)
        out = tf(x, torch.from_numpy(ids).to(torch.int64), 5)
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(n(x.grad), np.asarray(gj))
        assert np.isfinite(n(out)).all()


# ------------------------------------------------------------- layers


def test_masked_batchnorm_train_matches_jax():
    """Train-mode output (statistics over valid points only) and the running
    statistics after two updates, also under bfloat16 input (statistics in
    float32). Tolerance 1e-5 (f32), one bf16 ulp of the output (bf16)."""
    rng = np.random.default_rng(4)
    x = (3.0 + 2.0 * rng.normal(size=(50, 6))).astype(np.float32)
    mask = rng.uniform(size=50) > 0.3
    bn = jlayers.MaskedBatchNorm()
    variables = bn.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask),
                        False)
    params = {"scale": jnp.asarray(rng.uniform(0.5, 2, 6).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=6).astype(np.float32))}
    tbn = MaskedBatchNorm(6).train()
    with torch.no_grad():
        tbn.scale.copy_(torch.tensor(np.asarray(params["scale"])))
        tbn.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    stats = variables["batch_stats"]
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        y_j, mut = bn.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x, jdtype), jnp.asarray(mask), True,
                            mutable=["batch_stats"])
        stats = mut["batch_stats"]
        y_t = tbn(torch.from_numpy(x).to(dtype), torch.from_numpy(mask))
        assert y_t.dtype == dtype
        np.testing.assert_allclose(n(y_t.float()),
                                   np.asarray(y_j.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(n(tbn.mean), np.asarray(stats["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(tbn.var), np.asarray(stats["var"]),
                                   rtol=1e-5, atol=1e-6)
    # no valid point: the count clamps at 1 and nothing is NaN
    y0 = tbn(torch.from_numpy(x), torch.zeros(50, dtype=torch.bool))
    assert torch.isfinite(y0).all() and torch.isfinite(tbn.var).all()


def test_droppath_keeps_whole_rows_and_rescales():
    x = torch.ones(4000, 3)
    dp = DropPath(0.3).train()
    y = dp(x, torch.Generator().manual_seed(0))
    rows = y[:, 0]
    assert torch.equal(y, rows[:, None].expand_as(y))
    assert set(torch.unique(rows).tolist()) <= {
        0.0, float(torch.tensor(1.0) / 0.7)}
    assert abs(float((rows > 0).float().mean()) - 0.7) < 0.03
    assert torch.equal(dp(x, torch.Generator().manual_seed(0)), y)
    assert DropPath(0.3).eval()(x) is x


# ---------------------------------------------------------- optimizer


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Sequential(torch.nn.Linear(4, 3))
        self.backbone.add_module("attn", torch.nn.Linear(3, 3))
        self.head_means = torch.nn.Linear(3, 2)
        self.head_scales = torch.nn.Linear(3, 2)


def _nested(named):
    tree = {}
    for name, arr in named.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grad_clip_norm=0.5),
    dict(schedule="cosine", warmup_steps=2, total_steps=6),
    dict(schedule="linear", total_steps=5, accumulate_steps=2),
    dict(finetune_filter=("attn",)),
    dict(optimizer_type="sgd", grad_clip_norm=0.0),
], ids=["adam", "clip", "warmup-cosine", "linear-accum2", "finetune", "sgd"])
def test_optimizer_matches_optax(kw):
    """The port's optimizer against optim.build_optimizer's optax chain on
    the same gradients over 6 steps: per-group learning rates, eps 1e-15,
    clip, schedules, accumulation and the finetune filter. Tolerance 1e-6
    relative (float32 rounding of the schedule and bias correction)."""
    torch.manual_seed(0)
    model = _Tiny()
    lr_dict = {"base": 1e-2, "backbone": 3e-2, "means": 5e-3}
    args = dict(lr_dict=lr_dict, optimizer_type="adam", eps=1e-15,
                schedule="constant", total_steps=100, warmup_steps=0,
                grad_clip_norm=2.0, accumulate_steps=1, finetune_filter=None)
    args.update(kw)
    opt = build_optimizer(model, **args)
    # copies: jnp.asarray may alias a numpy view of the torch parameters
    params = _nested({k: n(v).copy() for k, v in model.named_parameters()})
    tx = joptim.build_optimizer(params, **args)
    state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(6):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        upd, state = tx.update(_nested(grads), state, params)
        params = optax.apply_updates(params, upd)
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    for k, p in model.named_parameters():
        np.testing.assert_allclose(n(p), flat[k], rtol=1e-6, atol=1e-7)
    if "finetune_filter" in kw:
        torch.manual_seed(0)
        untouched = _Tiny()
        assert torch.equal(model.head_means.weight,
                           untouched.head_means.weight)
        assert not torch.equal(model.backbone.attn.weight,
                               untouched.backbone.attn.weight)


def test_schedule_values():
    s = build_schedule(1.0, "cosine", 10, warmup_steps=4)
    assert [s(c) for c in (0, 2, 4)] == [0.0, 0.5, 1.0]
    assert s(9) == pytest.approx(0.5 * (1 + np.cos(np.pi * 5 / 10)))
    assert build_schedule(2.0, "linear", 4)(3) == pytest.approx(0.5)
    with pytest.raises(NotImplementedError):
        build_schedule(1.0, "step", 4)


# --------------------------------------------------------------- LPIPS


def _lpips_arrays(seed):
    rng = np.random.default_rng(seed)
    arrays = {}
    for key, shape in jlpips.expected_weight_shapes().items():
        if key.endswith("kernel"):
            fan_in = shape[0] * shape[1] * shape[2]
            arrays[key] = (rng.normal(size=shape) / np.sqrt(fan_in))
        elif key.endswith("bias"):
            arrays[key] = 0.01 * rng.normal(size=shape)
        else:
            arrays[key] = rng.uniform(0.0, 1.0, size=shape)
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def test_lpips_matches_jax(tmp_path):
    """The port's LPIPS against the JAX LPIPS on seeded random weights read
    from the same npz: distances within 1e-5 relative, the gradient with
    respect to the first image within 1e-4 of its largest magnitude; the
    file contract (missing -> None, malformed -> ValueError)."""
    arrays = _lpips_arrays(6)
    path = tmp_path / "lpips.npz"
    np.savez(path, **arrays)
    jparams = jlpips.load_lpips_params(str(path))
    model = tlpips.LPIPS()
    model.load_state_dict(tlpips.load_lpips_params(str(path)))
    rng = np.random.default_rng(7)
    a = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    d_j, g_j = jax.value_and_grad(lambda x: jnp.sum(jlpips.LPIPS().apply(
        {"params": jparams}, x, jnp.asarray(b))))(jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    d_t = model(at, torch.from_numpy(b))
    d_t.sum().backward()
    np.testing.assert_allclose(float(d_t.detach().sum()), float(d_j),
                               rtol=1e-5)
    g_j = np.asarray(g_j)
    assert float(np.abs(n(at.grad) - g_j).max()) <= 1e-4 * np.abs(g_j).max()

    assert tlpips.load_lpips_params(str(tmp_path / "absent.npz")) is None
    bad = dict(arrays)
    bad["lin2"] = bad["lin2"][:5]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="lin2"):
        tlpips.load_lpips_params(str(tmp_path / "bad.npz"))


def test_order_shuffle_matches_jax(monkeypatch):
    """serialize(..., perm) against the JAX package's shuffled serialize with
    its permutation fixed to the same one (jax.random streams cannot be
    reproduced in torch): codes, orders and inverses equal."""
    from splatformer_tpu.ops.serialization import serialize as jserialize
    from splatformer_tpu_torch.ops.serialization import serialize
    perm = (2, 0, 3, 1)
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(perm, jnp.int32))
    rng = np.random.default_rng(8)
    grid = rng.integers(0, 40, (200, 3)).astype(np.int32)
    mask = rng.uniform(size=200) > 0.1
    ref = jserialize(jnp.asarray(grid), jnp.asarray(mask),
                     shuffle_rng=jax.random.key(0))
    got = serialize(torch.from_numpy(grid), torch.from_numpy(mask),
                    perm=torch.tensor(perm))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n(g), np.asarray(r))
