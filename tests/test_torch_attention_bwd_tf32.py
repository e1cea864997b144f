"""The float32 K3 backward's order of operations (split TF32, three
tensor-core products a product, in a dQ pass and a dK/dV pass), emulated
in PyTorch on the CPU, against the plain version
(kernels/attention.py:attention_bwd_plain) within the limit that
chip_smoke.py holds the card to.

csrc/attention_bwd.cu runs the float32 backward on the tensor cores as
mma.sync m16n8k8 TF32 products, with the forward's scheme
(tests/test_torch_attention_tf32.py): every operand x is split into hi =
tf32(x) and lo = tf32(x - hi) and each product is a_lo b_hi + a_hi b_lo,
then a_hi b_hi. The dQ pass walks 64-key tiles: S = q k^T and dP = do v^T
(reductions over d in k8 steps), P = 2^(S c - lse log2 e) from the float32
logits, dS = (dP - D) P scale in float32, and the tile's dS k (a reduction
over its keys in k8 steps) in an accumulator of its own, added to dq once a
tile. The dK/dV pass walks 64-query tiles the same way with S^T = k q^T and
dP^T = v do^T, and sums P^T do and dS^T q a tile at a time into dv and dk.
This file shows, without a card, that this order fits the float32 limit at
every head width, also where one row's logits lie 30 apart (dS there is the
difference of two near-equal terms), and that one TF32 product would not.
The plain version is held against the JAX Pallas kernel in
tests/test_torch_attention.py. Torch only, no JAX.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.kernels.attention import (  # noqa: E402
    attention_bwd_plain, attention_fwd_plain)

# chip_smoke.py's float32 limit: each gradient relative to its largest
# magnitude
K3_BWD_TOL = 1e-4
TILE, K8 = 64, 8   # rows a staged tile; the reduction depth of one mma
LOG2E = 1.0 / math.log(2.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU runs: torch's default, a
    thread per core in each of the suite's parallel workers,
    oversubscribes the cores they share
    (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """float32 rounded to TF32 by its bits, as cvt.rna.tf32.f32: add half
    of the 13 dropped bits' range to the magnitude, then clear them (ties
    away from zero; a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_sum(a, b, products):
    """a @ b from zero as the kernels' mma steps: for each chunk of 8 along
    the reduction, the three TF32 products small terms first (or, with
    ``products`` 1, a single TF32 product), each one mma's sum of 8
    products added to the float32 accumulator."""
    if products == 3:
        (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    else:
        terms = ((tf32(a), tf32(b)),)
    n = a.shape[-1] // K8
    parts = [torch.einsum("...mcx,...cxn->c...mn",
                          x.unflatten(-1, (n, K8)), y.unflatten(-2, (n, K8)))
             for x, y in terms]
    acc = torch.zeros(parts[0].shape[1:])
    for c in range(n):
        for part in parts:
            acc = acc + part[c]
    return acc


def emulate_bwd(q, k, v, o, lse, do, scale, products=3):
    """attention_bwd_{dq,dkv}_tf32x3_kernel's order. dQ pass, per 64-key
    tile: S, dP by mma_sum over d, P = 2^(S c - lse log2 e), dS = (dP - D)
    P scale, dq += mma_sum(dS, k_tile) over the tile's keys. dK/dV pass,
    per 64-query tile: S^T, dP^T by mma_sum over d with k and v as the
    left-hand operands, dv += mma_sum(P^T, do_tile), dk += mma_sum(dS^T,
    q_tile) over the tile's queries. D = rowsum(o do) in float32."""
    c = scale * LOG2E
    nl = -lse * LOG2E
    di = (o * do).sum(-1)
    dq, dk, dv = (torch.zeros(q.shape) for _ in range(3))
    for t0 in range(0, q.shape[-2], TILE):
        rows = slice(t0, t0 + TILE)
        # dQ pass: keys t0.. of every query
        s = mma_sum(q, k[..., rows, :].transpose(-1, -2), products)
        dp = mma_sum(do, v[..., rows, :].transpose(-1, -2), products)
        p = torch.exp2(s * c + nl[..., None])
        ds = (dp - di[..., None]) * p * scale
        dq = dq + mma_sum(ds, k[..., rows, :], products)
        # dK/dV pass: queries t0.. of every key
        st = mma_sum(k, q[..., rows, :].transpose(-1, -2), products)
        dpt = mma_sum(v, do[..., rows, :].transpose(-1, -2), products)
        pt = torch.exp2(st * c + nl[..., None, rows])
        dst = (dpt - di[..., None, rows]) * pt * scale
        dv = dv + mma_sum(pt, do[..., rows, :], products)
        dk = dk + mma_sum(dst, q[..., rows, :], products)
    return dq, dk, dv


def _inputs(d, seq, kind, seed):
    """(2 patches, 2 heads, seq, d) float32 q, k, v and a cotangent, q at
    twice unit scale. ``rescale``: row 5 of head (0, 1) has one key, in
    the patch's last tile, 30 above its other logits."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(2, 2, seq, d)) for _ in range(4))
    q = 2.0 * q
    scale = d ** -0.5
    row, key = 5, seq - 24
    if kind == "rescale":
        k[0, 1, key] = q[0, 1, row] * (30.0 / (scale * np.square(
            q[0, 1, row]).sum()))
    q, k, v, do = (torch.from_numpy(x.astype(np.float32))
                   for x in (q, k, v, do))
    if kind == "rescale":
        logits = (q[0, 1, row] @ k[0, 1].T) * scale
        assert int(logits.argmax()) == key
        assert float(logits.max() - logits.min()) >= 30.0
    return q, k, v, do, scale


def _errors(d, seq, kind, products):
    """Each emulated gradient's largest error relative to the plain
    version's largest magnitude."""
    q, k, v, do, scale = _inputs(d, seq, kind, seed=70 + d + seq)
    o, lse = attention_fwd_plain(q, k, v, scale)
    got = emulate_bwd(q, k, v, o, lse, do, scale, products)
    want = attention_bwd_plain(q, k, v, o, lse, do, scale)
    return [float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(got, want)]


CASES = ([(d, 1024, kind) for kind in ("plain", "rescale")
          for d in (16, 24, 32)]
         + [(d, seq, "rescale") for seq in (64, 192) for d in (16, 24, 32)])


@pytest.mark.parametrize("d,seq,kind", CASES,
                         ids=[f"{kind}-d{d}-K{seq}" for d, seq, kind in CASES])
def test_tf32x3_bwd_order_fits_the_float32_limit(d, seq, kind):
    """The emulated kernels' dq, dk and dv each within K3_BWD_TOL of the
    plain version's largest magnitude, on 4 patch heads."""
    errs = _errors(d, seq, kind, products=3)
    assert max(errs) <= K3_BWD_TOL, errs


@pytest.mark.parametrize("d", [16, 24, 32])
def test_one_tf32_product_misses_the_float32_limit(d):
    """Control: the same order with a single TF32 product (hi x hi) misses
    the limit by far, so the split is what holds it."""
    errs = _errors(d, 1024, "plain", products=1)
    assert min(errs) > 10 * K3_BWD_TOL, errs
