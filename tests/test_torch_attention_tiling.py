"""The bfloat16 K3 kernels' order of operations, emulated in PyTorch on the
CPU, against the plain versions (kernels/attention.py) within the
tolerances that chip_smoke.py holds the card to.

The tensor-core kernels (csrc/attention_fwd.cu, csrc/attention_bwd.cu)
round and sum in their own order: the forward walks 64-key tiles with one
running-max update and one rescale of the float32 accumulator a tile,
rounds P to bfloat16 relative to the running max, and takes the row sum l
from the float32 P; the backward's two passes recompute P from lse 16 rows
at a time and round P and dS to bfloat16 before their products. This file
shows, without a card, that this blocking fits K3_FWD_TOL, K3_LSE_TOL and
K3_BWD_TOL. The plain versions are held against the JAX Pallas kernel in
tests/test_torch_attention.py. Torch only, no JAX.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.kernels.attention import (  # noqa: E402
    attention_bwd_plain, attention_fwd_plain)

# chip_smoke.py's bfloat16 limits: o and the gradients relative to their
# largest magnitude, lse absolute
K3_FWD_TOL, K3_LSE_TOL, K3_BWD_TOL = 1e-2, 2e-5, 2e-2
TILE, SLICE = 64, 16   # keys a staged tile; rows an mma k16 step
LOG2E = 1.0 / math.log(2.0)

bf16 = torch.bfloat16


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


def _round(x):
    """float32 rounded to bfloat16 and back: the kernels' pack to bf16x2."""
    return x.to(bf16).float()


def emulate_fwd(q, k, v, scale):
    """attention_fwd_bf16_kernel's order: per 64-key tile S = q k^T in
    float32, m = max(m, rowmax(S) c), one rescale of acc and l by
    2^(m_old - m), P = 2^(S c - m), l += rowsum(P) in float32, acc +=
    bf16(P) v; o = bf16(acc / l), lse = m ln 2 + log l."""
    qf, kf, vf = q.float(), k.float(), v.float()
    c = scale * LOG2E
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t0 in range(0, k.shape[-2], TILE):
        s = qf @ kf[..., t0:t0 + TILE, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _round(p) @ vf[..., t0:t0 + TILE, :]
        m = m_new
    return (acc / l[..., None]).to(q.dtype), m * math.log(2.0) + torch.log(l)


def emulate_bwd(q, k, v, o, lse, do, scale):
    """The two passes' order: D = rowsum(o do) in float32; the dQ pass over
    16 keys at a time (P = 2^(S c - lse log2 e), dS = (dP - D) P scale
    rounded to bf16, dq += dS k); the dK/dV pass over 16 queries at a time
    (dv += bf16(P)^T do, dk += bf16(dS)^T q)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    c = scale * LOG2E
    di = (o.float() * dof).sum(-1)
    nl = -lse * LOG2E

    def p_ds(rows, cols):
        s = qf[..., rows, :] @ kf[..., cols, :].transpose(-1, -2)
        p = torch.exp2(s * c + nl[..., rows, None])
        dp = dof[..., rows, :] @ vf[..., cols, :].transpose(-1, -2)
        return p, (dp - di[..., rows, None]) * p * scale

    n = q.shape[-2]
    dq, dk, dv = (torch.zeros(q.shape) for _ in range(3))
    for j in range(0, n, SLICE):      # dQ pass: 16 keys a step
        _, ds = p_ds(slice(None), slice(j, j + SLICE))
        dq += _round(ds) @ kf[..., j:j + SLICE, :]
    for i in range(0, n, SLICE):      # dK/dV pass: 16 queries a step
        p, ds = p_ds(slice(i, i + SLICE), slice(None))
        dv += _round(p).transpose(-1, -2) @ dof[..., i:i + SLICE, :]
        dk += _round(ds).transpose(-1, -2) @ qf[..., i:i + SLICE, :]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


@pytest.mark.parametrize("d,spread", [(16, False), (24, False), (32, False),
                                      (16, True)],
                         ids=["d16", "d24", "d32", "d16-logits-30-apart"])
def test_bf16_tiling_fits_the_card_tolerances(d, spread):
    """(1 patch, 2 heads, 256 keys, d), q at twice unit scale so logits
    spread beyond N(0, 1); with ``spread`` one row's largest logit (30
    above the rest) sits in the last tile, so that row's accumulator is
    rescaled by ~exp(-30) late. The emulation's o, lse and gradients
    against the plain versions' within the card's bf16 tolerances."""
    rng = np.random.default_rng(40 + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 2, 256, d)).astype(
        np.float32)) for _ in range(4))
    q = 2.0 * q
    scale = d ** -0.5
    if spread:
        k[0, 1, 230] = q[0, 1, 5] * (30.0 / (scale * float(
            q[0, 1, 5].square().sum())))
    q, k, v, do = (x.to(bf16) for x in (q, k, v, do))
    if spread:
        logits = (q[0, 1, 5].float() @ k[0, 1].float().T) * scale
        assert int(logits.argmax()) == 230
        assert float(logits.max() - logits.min()) >= 30.0
    o, lse = emulate_fwd(q, k, v, scale)
    o_p, lse_p = attention_fwd_plain(q, k, v, scale)
    assert o.dtype == bf16 and lse.dtype == torch.float32
    assert _rel_err(o, o_p) <= K3_FWD_TOL
    assert float((lse - lse_p).abs().max()) <= K3_LSE_TOL
    grads = emulate_bwd(q, k, v, o_p, lse_p, do, scale)
    want = attention_bwd_plain(q, k, v, o_p, lse_p, do, scale)
    for name, g, w in zip("qkv", grads, want):
        assert g.dtype == bf16, name
        assert _rel_err(g, w) <= K3_BWD_TOL, name
