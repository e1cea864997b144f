"""The float32 K3 forward's order of operations (split TF32, three tensor-core
products a product), emulated in PyTorch on the CPU, against the plain
version (kernels/attention.py:attention_fwd_plain) within the limits that
chip_smoke.py holds the card to.

csrc/attention_fwd.cu runs float32 attention on the tensor cores as
mma.sync m16n8k8 TF32 products. TF32 keeps 10 of float32's 23 mantissa
bits, so the kernel splits every operand x into hi = tf32(x) and lo =
tf32(x - hi) (cvt.rna: round to nearest, ties away from zero) and forms
each product as a_lo b_hi + a_hi b_lo, then a_hi b_hi, into one float32
accumulator; only a_lo b_lo (~2^-22 relative) is dropped. It walks 64-key
tiles with one running-max update and one rescale a tile, sums each mma's
8 products (d for q k^T, keys for P v) and adds them to the accumulator,
sums a tile's P v in an accumulator of its own that one FFMA adds to the
rescaled O, and takes l from the float32 P. This file shows, without a
card, that this order fits the float32 limits, and that one TF32 product
would not. The plain version is held against the JAX Pallas kernel in
tests/test_torch_attention.py. Torch only, no JAX.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.kernels.attention import \
    attention_fwd_plain  # noqa: E402

# chip_smoke.py's float32 limits: o relative to its largest magnitude, lse
# absolute
K3_FWD_TOL, K3_LSE_TOL = 2e-5, 2e-5
TILE, K8 = 64, 8   # keys a staged tile; the reduction depth of one mma
LOG2E = 1.0 / math.log(2.0)


def tf32(x):
    """float32 rounded to TF32 by its bits, as cvt.rna.tf32.f32: add half
    of the 13 dropped bits' range to the magnitude, then clear them (ties
    away from zero; a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_sum(acc, a, b, products):
    """acc += a @ b as the kernel's mma steps: for each chunk of 8 along
    the reduction, the three TF32 products small terms first (or, with
    ``products`` 1, a single TF32 product), each one mma's sum of 8
    products added to the float32 accumulator."""
    if products == 3:
        (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    else:
        terms = ((tf32(a), tf32(b)),)
    n = a.shape[-1] // K8
    # (chunk, ..., M, N) products of each 8-deep chunk, per term
    parts = [torch.einsum("...mcx,...cxn->c...mn",
                          x.unflatten(-1, (n, K8)), y.unflatten(-2, (n, K8)))
             for x, y in terms]
    for c in range(n):
        for part in parts:
            acc = acc + part[c]
    return acc


def emulate_fwd(q, k, v, scale, products=3):
    """attention_fwd_tf32x3_kernel's order: per 64-key tile S = q k^T by
    mma_sum, m = max(m, rowmax(S) c), corr = 2^(m_old - m), l = l corr +
    rowsum(P) with P = 2^(S c - m) in float32, acc = acc corr + P v with
    P v by mma_sum from zero; o = acc / l, lse = m ln 2 + log l."""
    c = scale * LOG2E
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t0 in range(0, k.shape[-2], TILE):
        kt, vt = k[..., t0:t0 + TILE, :], v[..., t0:t0 + TILE, :]
        s = mma_sum(torch.zeros(q.shape[:-1] + (TILE,)), q,
                    kt.transpose(-1, -2), products)
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mma_sum(torch.zeros(acc.shape), p,
                                              vt, products)
        m = m_new
    return acc / l[..., None], m * math.log(2.0) + torch.log(l)


def _inputs(d, seq, kind, seed):
    """(2 patches, 4 heads, seq, d) float32 q, k, v, q at twice unit scale.
    ``rescale``: row 5 of head (0, 1) has one key, in the patch's last tile,
    30 above its other logits, so its accumulator is rescaled by ~exp(-30)
    late. ``wide``: operands spread over 1e-3 to 1e3 -- q's column j scaled
    by 10^e_j and k's by 10^-e_j (e_j uniform in [-3, 3]), so the logits
    stay those of the plain inputs while the operands' exponents, and the
    weight of their lo halves, range widely; each v element scaled by
    10^f (f uniform in [-3, 3])."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 4, seq, d)) for _ in range(3))
    q = 2.0 * q
    scale = d ** -0.5
    if kind == "rescale":
        row, key = 5, seq - 24
        k[0, 1, key] = q[0, 1, row] * (30.0 / (scale * np.square(
            q[0, 1, row]).sum()))
    elif kind == "wide":
        e = rng.uniform(-3.0, 3.0, size=d)
        q, k = q * 10.0 ** e, k * 10.0 ** -e
        v = v * 10.0 ** rng.uniform(-3.0, 3.0, size=v.shape)
    q, k, v = (torch.from_numpy(x.astype(np.float32)) for x in (q, k, v))
    if kind == "rescale":
        logits = (q[0, 1, row] @ k[0, 1].T) * scale
        assert int(logits.argmax()) == key
        assert float(logits.max() - logits.min()) >= 30.0
    elif kind == "wide":
        for x in (q, k, v):
            mag = x.abs()
            assert float(mag.min()) < 1e-3 and float(mag.max()) > 1e2
    return q, k, v, scale


def _errors(d, seq, kind, products):
    q, k, v, scale = _inputs(d, seq, kind, seed=50 + d + seq)
    o, lse = emulate_fwd(q, k, v, scale, products)
    o_p, lse_p = attention_fwd_plain(q, k, v, scale)
    o_err = float((o - o_p).abs().max()) / float(o_p.abs().max())
    return o_err, float((lse - lse_p).abs().max())


CASES = ([(d, 1024, "plain") for d in (16, 24, 32)]
         + [(d, seq, "plain") for seq in (64, 192) for d in (16, 24, 32)]
         + [(d, 1024, kind) for kind in ("rescale", "wide")
            for d in (16, 24, 32)])


@pytest.mark.parametrize("d,seq,kind", CASES,
                         ids=[f"{kind}-d{d}-K{seq}" for d, seq, kind in CASES])
def test_tf32x3_order_fits_the_float32_limits(d, seq, kind):
    """The emulated kernel's o within K3_FWD_TOL of the plain version's
    largest magnitude and its lse within K3_LSE_TOL, on 8 patch heads."""
    o_err, lse_err = _errors(d, seq, kind, products=3)
    assert o_err <= K3_FWD_TOL and lse_err <= K3_LSE_TOL, (o_err, lse_err)


@pytest.mark.parametrize("d", [16, 24, 32])
def test_one_tf32_product_misses_the_float32_limits(d):
    """Control: the same order with a single TF32 product (hi x hi) misses
    the limits by far, so the split is what holds them."""
    o_err, lse_err = _errors(d, 1024, "plain", products=1)
    assert o_err > 10 * K3_FWD_TOL and lse_err > 10 * K3_LSE_TOL, (
        o_err, lse_err)
