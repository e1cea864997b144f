"""The port's token merging (splatformer_tpu_torch/ops/merging.py) against
the JAX package's ops/merging.py on the CPU: each of the 10 modes on one
(B=3, H=2, K=64, c=16) case with planted ties (a padded tail patch repeats
one token, as pad_order_for_patches does, and some tokens are duplicated),
the bfloat16 dtype rules, single_head_tome, PiToMe's protected slots,
random_patch with injected draws, and the merge-count cap that makes every
rate from 0.5 up merge alike. The index tensors are read as routing
matrices: merge applied to the identity (K' x K) and unmerge applied to the
identity (K x K'); their nonzero patterns are the merge's and unmerge's
indices, and must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.ops import merging as jm  # noqa: E402
from splatformer_tpu_torch.ops import merging as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, H, K, C = 3, 2, 64, 16
INFO = {"r": 0.3, "margin": 0.9, "alpha": 1.0, "stride": 4,
        "threshold": 0.5, "low_r": 4}


def qkv(seed=0):
    """q, k, v (B, H, K, C) float32 with ties: the last 12 tokens repeat
    token 51 (a padded boundary patch), token 5 repeats token 8, and in k
    the adjacent pair (10, 11) and tokens 20 and 33 are equal."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.normal(size=(B, H, K, C)).astype(np.float32)
        x[..., K - 12:, :] = x[..., K - 13:K - 12, :]
        x[..., 5, :] = x[..., 8, :]
        out.append(x)
    out[1][..., 10, :] = out[1][..., 11, :]
    out[1][..., 20, :] = out[1][..., 33, :]
    return out


def eye(rows):
    return np.broadcast_to(np.eye(rows, dtype=np.float32), (B, H, rows, rows))


def jax_merge(mode, q, k, v, info, key=None):
    """The JAX package's process_merging and build_merge, jitted: q', k',
    v', size, unmerge(v') and the routing matrices."""
    def f(q, k, v):
        q2, k2, v2, size, unmerge = jm.process_merging(mode, q, k, v, info,
                                                       rng=key)
        merge, unmerge_b, _ = jm.build_merge(mode, k, info, rng=key)
        kp = q2.shape[-2]
        route = merge(jnp.broadcast_to(jnp.eye(K, dtype=q.dtype),
                                       q.shape[:2] + (K, K)))
        back = unmerge_b(jnp.broadcast_to(jnp.eye(kp, dtype=q.dtype),
                                          q.shape[:2] + (kp, kp)))
        return q2, k2, v2, size, unmerge(v2), route, back
    return [np.asarray(x, np.float32) for x in jax.jit(f)(q, k, v)]


def port_merge(mode, q, k, v, info, uniform=None):
    q2, k2, v2, size, unmerge = tm.process_merging(mode, q, k, v, info,
                                                   uniform)
    merge, unmerge_b, _ = tm.build_merge(mode, k, info, uniform)
    kp = q2.shape[-2]
    route = merge(torch.from_numpy(eye(K).copy()).to(q.dtype))
    back = unmerge_b(torch.from_numpy(eye(kp).copy()).to(q.dtype))
    return [x.float().numpy() for x in
            (q2, k2, v2, size, unmerge(v2), route, back)]


NAMES = ("q'", "k'", "v'", "size", "unmerge(v')", "merge(I)", "unmerge(I)")


def assert_same(got, ref, rel=1e-6):
    """Identical shapes and routing patterns; every value within ``rel`` of
    its tensor's largest magnitude."""
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        if name in ("merge(I)", "unmerge(I)"):
            np.testing.assert_array_equal(g != 0, r != 0, err_msg=name)
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * scale,
                                   err_msg=name)


def T(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("mode", tm.MERGE_MODES)
def test_mode_matches_jax(mode):
    """Every mode, float32, r = 0.3 (19 merges a patch): identical routing
    and size, q', k', v' and unmerge(v') within 1e-6 of their largest
    magnitude. random_patch without draws takes the blocks in order, as
    the JAX package does without an rng."""
    q, k, v = qkv()
    ref = jax_merge(mode, q, k, v, INFO)
    got = port_merge(mode, *T(q, k, v), INFO)
    assert_same(got, ref)
    kp = got[0].shape[-2]
    assert kp == {"patch": 46, "wpatch": 46, "random_patch": 46,
                  "important_patch": 46, "algm": K}.get(mode, K - 19)
    if mode == "algm":  # merged-away slots live on with size 0
        assert (got[3] == 0).any() and set(np.unique(got[3])) <= {0, 1, 2}


def test_bf16_tome_follows_the_dtype_rules():
    """bfloat16 q, k, v: scores and routing sums in float32, cast back;
    route and size in the metric's dtype. Outputs keep bfloat16 and agree
    with the JAX package's within bfloat16 rounding (a few ulps of the
    largest magnitude; one ulp is 2^-8 relative)."""
    q, k, v = qkv(1)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))

    def f(q, k, v):
        q2, k2, v2, size, unmerge = jm.process_merging("tome", q, k, v, INFO)
        return q2, k2, v2, size, unmerge(v2)
    ref = jax.jit(f)(qb, kb, vb)
    assert all(x.dtype == jnp.bfloat16 for x in ref)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    q2, k2, v2, size, unmerge = tm.process_merging("tome", tq, tk, tv, INFO)
    got = (q2, k2, v2, size, unmerge(v2))
    assert all(x.dtype == torch.bfloat16 for x in got)
    for name, g, r in zip(("q'", "k'", "v'", "size", "unmerge(v')"), got,
                          ref):
        r = np.asarray(r, np.float32)
        g = g.float().numpy()
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=4 * 2 ** -8 * np.abs(r).max(),
                                   err_msg=name)


def test_single_head_tome():
    """single_head_tome: one partition from the head-mean metric for every
    head."""
    q, k, v = qkv(2)
    info = dict(INFO, single_head_tome=True)
    ref = jax_merge("tome", q, k, v, info)
    got = port_merge("tome", *T(q, k, v), info)
    assert_same(got, ref)
    np.testing.assert_array_equal(got[5][:, 0] != 0, got[5][:, 1] != 0)


def test_pitome_protected_slots():
    """PiToMe with protected_ratio 0.1: the ceil(0.1 K) = 7 lowest-energy
    tokens (sorted slots 57-63) never merge; 3 of them are src slots, so
    r = 0.5 merges 29, not 32."""
    q, k, v = qkv(3)
    info = dict(INFO, r=0.5, protected_ratio=0.1)
    ref = jax_merge("pitome", q, k, v, info)
    got = port_merge("pitome", *T(q, k, v), info)
    assert_same(got, ref)
    assert got[0].shape[-2] == K - 29


def test_random_patch_with_injected_draws():
    """random_patch in training: the port's block scores injected as the
    JAX package's jax.random.uniform draws of the same key."""
    q, k, v = qkv(4)
    key = jax.random.key(11)
    ref = jax_merge("random_patch", q, k, v, INFO, key=key)

    def uniform(shape):
        return torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    got = port_merge("random_patch", *T(q, k, v), INFO, uniform)
    assert_same(got, ref)
    first = port_merge("random_patch", *T(q, k, v), INFO)
    assert not np.array_equal(got[5] != 0, first[5] != 0)


@pytest.mark.parametrize("mode", ["tome", "pitome", "tofu", "prune",
                                  "patch", "wpatch"])
def test_rates_from_half_up_merge_alike(mode):
    """merge_count caps the merges at K // 2, so r = 0.5, 0.7 and 0.9 give
    identical outputs (the JAX eval.csv's identical rows); r = 0.3 does
    not."""
    q, k, v = T(*qkv(5))
    outs = {r: port_merge(mode, q, k, v, dict(INFO, r=r))
            for r in (0.3, 0.5, 0.7, 0.9)}
    for r in (0.7, 0.9):
        for a, b in zip(outs[r], outs[0.5]):
            np.testing.assert_array_equal(a, b)
    assert outs[0.3][0].shape != outs[0.5][0].shape
    assert [tm.merge_count(128, r) for r in (0.1, 0.3, 0.5, 0.9)] == [
        12, 38, 64, 64]


def test_argmax_and_sort_tie_rules():
    """What the ties rely on: torch.argmax takes the first maximum and the
    stable argsort keeps index order among equal keys, as jnp.argmax and
    jnp.argsort do."""
    x = np.array([0.5, 3.0, 3.0, -1.0, 3.0], np.float32)
    assert int(torch.argmax(torch.from_numpy(x))) == int(
        jnp.argmax(jnp.asarray(x))) == 1
    keys = np.array([2.0, 1.0, 2.0, 1.0, 2.0, 1.0] * 20, np.float32)
    np.testing.assert_array_equal(
        torch.argsort(torch.from_numpy(keys), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(keys))))
