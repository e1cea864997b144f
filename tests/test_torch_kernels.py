"""The port's CUDA kernels (K1 compositing forward, K2 its backward, K3
patch attention forward and backward) on the card against their plain
PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs where
JAX is not installed. On a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(--noconftest skips tests/conftest.py, which sets up JAX). Without a card
the `cuda` tests skip; the build bookkeeping is checked everywhere.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from splatformer_tpu_torch.kernels.build import (BUILD_DIR, SOURCES,  # noqa: E402
                                                 library_path)


def test_every_kernel_has_a_source_and_a_counter():
    for name, src in SOURCES.items():
        path = library_path(name)
        assert path.parent == BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path == library_path(name)  # named by content, stable
        assert name in LAUNCHES
    reset_launches()
    assert set(LAUNCHES.values()) == {0}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_composite_kernel_matches_plain_on_card():
    """K1 on the card vs its plain version on the same CUDA inputs: outputs
    within 1e-5, walked counts exact, one counted launch."""
    _card()
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    scene = random_scene(np.random.default_rng(0), 20_000, sh_degree=1)
    cams = orbit_cameras(4, 128, 128)
    e = prepare_entries(scene, cams, RasterizeConfig())
    before = LAUNCHES["composite_fwd"]
    out_k, walked_k = composite_fwd(e.packed_t, e.tile_start, 8, 64)
    torch.cuda.synchronize()
    assert LAUNCHES["composite_fwd"] == before + 1
    out_p, walked_p = composite_fwd_plain(e.packed_t, e.tile_start, 8, 64)
    assert float((out_k - out_p).abs().max()) <= 1e-5
    assert torch.equal(walked_k, walked_p)
    assert float(out_k[..., 3].min()) < 0.5  # it really composited


@pytest.mark.cuda
def test_composite_kernel_empty_and_ragged_tiles():
    """Tiles with no entries, and ranges that are not multiples of the
    kernel's 256-entry staging batch."""
    _card()
    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain)
    rng = np.random.default_rng(1)
    budget = 1300
    packed = np.zeros((16, budget), np.float32)
    packed[0:2] = rng.uniform(0, 32, (2, budget))
    packed[2] = packed[4] = rng.uniform(0.05, 0.5, budget)
    packed[3] = rng.uniform(-0.02, 0.02, budget)
    packed[5] = rng.uniform(0.0, 0.9, budget)
    packed[6:9] = rng.uniform(0, 1, (3, budget))
    tile_start = np.array([0, 0, 257, 900, 1300], np.int32)
    args = (torch.from_numpy(packed).cuda(), torch.from_numpy(tile_start).cuda(),
            2, 4)
    out_k, walked_k = composite_fwd(*args)
    out_p, walked_p = composite_fwd_plain(*args)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= 1e-5
    assert torch.equal(walked_k, walked_p)
    assert torch.all(out_k[0, :, 3] == 1.0) and torch.all(walked_k[0] == 0)


# K2 against its plain version: every pixel's values round identically
# (the kernel is built with -fmad=false), only the order of the sum over
# a tile's 256 pixels differs, so each gradient row is held within 1e-4
# of its own largest magnitude; outside the replayed ranges exactly 0.
K2_TOL = 1e-4


def _check_k2(packed, tile_start, tiles_x, tiles_img, seed):
    from splatformer_tpu_torch.kernels.composite import (composite_bwd,
                                                         composite_bwd_plain,
                                                         composite_fwd)
    out, walked = composite_fwd(packed, tile_start, tiles_x, tiles_img)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn(out.shape, generator=gen, device="cuda")
    before = LAUNCHES["composite_bwd"]
    d_k = composite_bwd(packed, tile_start, tiles_x, tiles_img, out, walked,
                        g_out)
    torch.cuda.synchronize()
    assert LAUNCHES["composite_bwd"] == before + 1
    d_p = composite_bwd_plain(packed, tile_start, tiles_x, tiles_img, out,
                              walked, g_out)
    for r in range(9):
        scale = float(d_p[r].abs().max())
        assert scale > 0, r
        assert float((d_k[r] - d_p[r]).abs().max()) <= K2_TOL * scale, r
    # exact zeros outside each tile's replayed range [start, start + max
    # walked) and in the pad rows
    start = tile_start[:-1].long()
    stop = start + walked.long().max(dim=1).values
    edge = torch.zeros(packed.shape[1] + 1, dtype=torch.int64, device="cuda")
    edge.index_add_(0, start, torch.ones_like(start))
    edge.index_add_(0, stop, -torch.ones_like(stop))
    replayed = torch.cumsum(edge, 0)[:-1] > 0
    assert not bool(d_k[:, ~replayed].any()) and not bool(d_k[9:].any())
    return walked


@pytest.mark.cuda
def test_composite_bwd_kernel_matches_plain_on_card():
    """K2 on the card vs its plain version on the entries of a 20k-Gaussian
    scene under 4 views at 128^2, with a random cotangent (T channel
    included); one counted launch."""
    _card()
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    scene = random_scene(np.random.default_rng(0), 20_000, sh_degree=1)
    e = prepare_entries(scene, orbit_cameras(4, 128, 128), RasterizeConfig())
    _check_k2(e.packed_t, e.tile_start, 8, 64, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["sparse", "opaque"])
def test_composite_bwd_kernel_empty_and_ragged_tiles(opaque):
    """An empty tile, ranges that are not multiples of the kernel's
    128-entry batch, the max-alpha clamp active (opacity 1.0), pixels that
    terminate, and with ``opaque`` tiles whose longest walk stops before
    the range ends."""
    _card()
    rng = np.random.default_rng(2)
    budget = 1408
    packed = np.zeros((16, budget), np.float32)
    end = 1300
    packed[0:2, :end] = rng.uniform(0, 32, (2, end))
    lo, hi = (0.005, 0.05) if opaque else (0.05, 0.5)
    packed[2, :end] = rng.uniform(lo, hi, end)
    packed[4, :end] = rng.uniform(lo, hi, end)
    packed[3, :end] = rng.uniform(-0.2, 0.2, end) * np.sqrt(
        packed[2, :end] * packed[4, :end])
    packed[5, :end] = rng.uniform(0.5 if opaque else 0.1, 0.95, end)
    packed[5, :end][rng.uniform(size=end) < 0.1] = 1.0
    packed[6:9, :end] = rng.uniform(0, 1, (3, end))
    tile_start = np.array([0, 0, 257, 900, 1300], np.int32)
    walked = _check_k2(torch.from_numpy(packed).cuda(),
                       torch.from_numpy(tile_start).cuda(), 2, 4, seed=3)
    lengths = torch.from_numpy(np.diff(tile_start)).cuda()
    assert bool((walked < lengths[:, None]).any())  # pixels terminate
    if opaque:  # every tile stops before its range ends
        assert bool((walked.max(dim=1).values < lengths)[1:].all())


@pytest.mark.cuda
def test_composite_kernels_bit_identical_across_launches():
    """K1 and K2 launched twice on the same inputs (the entries of a
    20k-Gaussian scene under 4 views at 128^2, a seeded cotangent) give the
    same out, walked and d_packed bit for bit: no atomics, every sum in a
    fixed order."""
    _card()
    from splatformer_tpu_torch.data.synthetic import orbit_cameras, random_scene
    from splatformer_tpu_torch.kernels.composite import (composite_bwd,
                                                         composite_fwd)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    scene = random_scene(np.random.default_rng(4), 20_000, sh_degree=1)
    e = prepare_entries(scene, orbit_cameras(4, 128, 128), RasterizeConfig())
    args = (e.packed_t, e.tile_start, 8, 64)
    out, walked = composite_fwd(*args)
    out2, walked2 = composite_fwd(*args)
    gen = torch.Generator(device="cuda").manual_seed(6)
    g_out = torch.randn(out.shape, generator=gen, device="cuda")
    d = composite_bwd(*args, out, walked, g_out)
    d2 = composite_bwd(*args, out, walked, g_out)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(walked, walked2)
    assert torch.equal(d, d2) and bool(d.any())


@pytest.mark.cuda
def test_composite_kernels_match_plain_on_adversarial_entries():
    """K1 and K2 against their plain versions on the finite adversarial
    entries of tests/test_torch_composite_cull.py (alpha within a few ulps
    of the threshold at the nearest pixel, near-degenerate and
    non-definite conics, centres on box edges and corners): K1's out within
    1e-5 and walked exact, K2 within K2_TOL of each row's largest
    magnitude with exact zeros outside the replayed ranges."""
    _card()
    from test_torch_composite_cull import adversarial_entries

    from splatformer_tpu_torch.kernels.composite import (composite_fwd,
                                                         composite_fwd_plain)
    packed, tile_start, tiles_x, tiles_img = adversarial_entries(
        finite_only=True)
    args = (packed.cuda(), tile_start.cuda(), tiles_x, tiles_img)
    out_k, walked_k = composite_fwd(*args)
    torch.cuda.synchronize()
    out_p, walked_p = composite_fwd_plain(*args)
    assert float((out_k - out_p).abs().max()) <= 1e-5
    assert torch.equal(walked_k, walked_p)
    _check_k2(*args, seed=7)


# K3 against its plain version (chip_smoke.py K3_*_TOL): float32 sums in
# another order (~1e-6 of the largest magnitude); bfloat16 also rounds P, dS
# and the outputs to bfloat16 in both, where a float32 difference can flip a
# rounding (one bf16 ulp is 3.9e-3 relative)
K3_FWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
K3_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def _check_k3(q, k, v, do, dtype):
    """K3-fwd and K3-bwd against their plain versions on the same CUDA
    inputs: o within K3_FWD_TOL, lse within 2e-5, each gradient within
    K3_BWD_TOL of its largest magnitude; one counted launch each. Returns
    (o, lse) and the gradients."""
    from splatformer_tpu_torch.kernels.attention import (attention_bwd,
                                                         attention_bwd_plain,
                                                         attention_fwd,
                                                         attention_fwd_plain)
    scale = q.shape[-1] ** -0.5
    before = dict(LAUNCHES)
    o, lse = attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = attention_fwd_plain(q, k, v, scale)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert _rel_err(o, o_p) <= K3_FWD_TOL[dtype]
    assert float((lse - lse_p).abs().max()) <= 2e-5
    grads = attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want = attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, g, w in zip("qkv", grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= K3_BWD_TOL[dtype], name
    assert LAUNCHES["attention_fwd"] == before["attention_fwd"] + 1
    assert LAUNCHES["attention_bwd"] == before["attention_bwd"] + 1
    return (o, lse), grads


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [64, 192, 1024])
@pytest.mark.parametrize("d", [16, 24, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_match_plain_on_card(seq, d, dtype):
    """K3-fwd and K3-bwd on (3 patches, 2 heads, seq, d) against their
    plain versions (_check_k3), with q, k, v and the cotangent given as
    strided views of one (B, K, 4, H, d) tensor, as the model's qkv split
    gives them. seq 64 is one tile; 192 ends on a tile edge that is not a
    multiple of 128."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    packed = torch.randn((3, seq, 4, 2, d), generator=gen, device="cuda")
    packed[:, :, 0] *= 2.0
    q, k, v, do = packed.to(getattr(torch, dtype)).permute(2, 0, 3, 1,
                                                          4).unbind(0)
    _check_k3(q, k, v, do, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 24, 32])
def test_attention_bf16_rescale_and_determinism_on_card(d):
    """bfloat16 K3 where one row's logits lie 30 apart, the largest in the
    patch's last 64-key tile, so the online softmax rescales that row's
    accumulator by ~exp(-30) late: within the tolerances of _check_k3, the
    row's output close to the dominant key's value. Then the backward again
    on the same inputs: bit-identical, as no pass uses atomics."""
    _card()
    from splatformer_tpu_torch.kernels.attention import attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(100 + d)
    q, k, v, do = (torch.randn((2, 2, 256, d), generator=gen, device="cuda")
                   for _ in range(4))
    scale = d ** -0.5
    row, key = 5, 230
    # k[key] along q[row], at a logit of 30 (the others are ~N(0, 1))
    k[0, 1, key] = q[0, 1, row] * (30.0 / (scale * float(
        q[0, 1, row].square().sum())))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    logits = (q[0, 1, row].float() @ k[0, 1].float().T) * scale
    assert float(logits.max() - logits.min()) >= 30.0
    assert int(logits.argmax()) == key
    (o, lse), grads = _check_k3(q, k, v, do, "bfloat16")
    assert float((o[0, 1, row].float() - v[0, 1, key].float()).abs().max()) \
        <= 0.05 * float(v[0, 1, key].float().abs().max())
    again = attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    for name, g, h in zip("qkv", grads, again):
        assert torch.equal(g, h), name


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [64, 192])
@pytest.mark.parametrize("d", [16, 24, 32])
def test_attention_f32_bwd_rescale_and_determinism_on_card(d, seq):
    """float32 K3-bwd (split-TF32 dQ and dK/dV passes on the tensor cores,
    as tests/test_torch_attention_bwd_tf32.py emulates them) on (2 patches,
    4 heads, seq, d) where one row's logits lie 30 apart, the largest in
    the patch's last 64-key tile: P is ~1 at that key and ~exp(-30) beside
    it, and dS there is the difference of two near-equal terms, dP - D.
    Each gradient within K3_BWD_TOL of its largest magnitude (_check_k3);
    then the backward again on the same inputs, bit-identical, as neither
    pass uses atomics."""
    _card()
    from splatformer_tpu_torch.kernels.attention import attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(300 + d + seq)
    q, k, v, do = (torch.randn((2, 4, seq, d), generator=gen, device="cuda")
                   for _ in range(4))
    q = 2.0 * q
    scale = d ** -0.5
    row, key = 5, seq - 24
    k[0, 1, key] = q[0, 1, row] * (30.0 / (scale * float(
        q[0, 1, row].square().sum())))
    logits = (q[0, 1, row] @ k[0, 1].T) * scale
    assert float(logits.max() - logits.min()) >= 30.0
    assert int(logits.argmax()) == key
    (o, lse), grads = _check_k3(q, k, v, do, "float32")
    before = LAUNCHES["attention_bwd"]
    again = attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_bwd"] == before + 1
    for name, g, h in zip("qkv", grads, again):
        assert g.dtype == torch.float32, name
        assert torch.equal(g, h), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rescale", "wide"])
@pytest.mark.parametrize("d", [16, 24, 32])
def test_attention_f32_fwd_rescale_wide_and_determinism_on_card(d, kind):
    """float32 K3-fwd (split-TF32 products on the tensor cores) on (2
    patches, 4 heads, 1024, d), as tests/test_torch_attention_tf32.py
    emulates it. ``rescale``: one row's logits lie 30 apart, the largest in
    the patch's last 64-key tile, so the online softmax rescales that row's
    accumulator by ~exp(-30) late; its output is the dominant key's value.
    ``wide``: operands spread over 1e-3 to 1e3 (q's column j scaled by
    10^e_j and k's by 10^-e_j, e_j uniform in [-3, 3], so the logits stay
    those of unit inputs; each v element scaled by 10^f, f uniform in [-3,
    3]), so the split's lo halves work at every exponent. o within
    K3_FWD_TOL of its largest magnitude and lse within 2e-5 of the plain
    version's; a second run bit-identical, as the kernel uses no atomics."""
    _card()
    from splatformer_tpu_torch.kernels.attention import (attention_fwd,
                                                         attention_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(200 + d)
    q, k, v = (torch.randn((2, 4, 1024, d), generator=gen, device="cuda")
               for _ in range(3))
    q = 2.0 * q
    scale = d ** -0.5
    row, key = 5, 1000
    if kind == "rescale":
        k[0, 1, key] = q[0, 1, row] * (30.0 / (scale * float(
            q[0, 1, row].square().sum())))
        logits = (q[0, 1, row] @ k[0, 1].T) * scale
        assert float(logits.max() - logits.min()) >= 30.0
        assert int(logits.argmax()) == key
    else:
        e = 6.0 * torch.rand(d, generator=gen, device="cuda") - 3.0
        q, k = q * 10.0 ** e, k * 10.0 ** -e
        v = v * 10.0 ** (6.0 * torch.rand(v.shape, generator=gen,
                                          device="cuda") - 3.0)
        for x in (q, k, v):
            assert float(x.abs().min()) < 1e-3 and float(x.abs().max()) > 1e2
    before = LAUNCHES["attention_fwd"]
    o, lse = attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = attention_fwd_plain(q, k, v, scale)
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert _rel_err(o, o_p) <= K3_FWD_TOL["float32"]
    assert float((lse - lse_p).abs().max()) <= 2e-5
    if kind == "rescale":
        assert float((o[0, 1, row] - v[0, 1, key]).abs().max()) \
            <= 1e-5 * float(v[0, 1, key].abs().max())
    o2, lse2 = attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert LAUNCHES["attention_fwd"] == before + 2


@pytest.mark.cuda
def test_attention_replay_matches_flash_capture_on_card():
    """A tiny enable_flash model (patch 64, head widths 16, 24 and 16) on
    512 Gaussians: the attention recorded under capture is K3-fwd's float32
    output, once a block; the plain per-head replay (utils/attn_replay.py,
    float32 products, TF32 off) concatenated over heads equals it within
    1e-4 of its largest magnitude."""
    _card()
    from splatformer_tpu_torch.data.synthetic import random_scene
    from splatformer_tpu_torch.models.feature_predictor import (
        FeaturePredictor, init_weights)
    from splatformer_tpu_torch.utils.attn_replay import (
        collect_attention_blocks, head_count_for, replay_block)
    bk = dict(enc_depths=(1, 1), enc_channels=(32, 48), enc_num_head=(2, 2),
              enc_patch_size=(64, 64), dec_depths=(1,), dec_channels=(32,),
              dec_num_head=(2,), dec_patch_size=(64,), stride=(2,),
              drop_path=0.0, use_flash=True)
    model = FeaturePredictor(backbone_kwargs=bk, grid_resolution=64).eval()
    init_weights(model, torch.Generator().manual_seed(0), zeroinit=False)
    model = model.cuda()
    scene = random_scene(np.random.default_rng(0), 512, device="cuda")
    reset_launches()
    recs = collect_attention_blocks(model, scene)
    assert LAUNCHES["attention_fwd"] == len(recs) == 3
    for path, rec in recs.items():
        rep = replay_block(rec, head_count_for(path, bk), 64)
        got = np.concatenate(rep["attn_feats"], axis=1)
        want = rec["attn_feat"].cpu().numpy()
        assert want.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), path
