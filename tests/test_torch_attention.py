"""K3, the port's patch attention (kernels/attention.py), on the CPU against
the JAX package's flash-attention kernel: the Pallas TPU kernel itself, run
in TPU interpret mode, with the head width zero-padded to 128 as
splatformer_tpu/models/ptv3.py pads it. On the CPU the port's wrappers take
their plain versions; the CUDA kernels are held against those on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.experimental.pallas.ops.tpu import flash_attention as fa  # noqa: E402

from splatformer_tpu_torch.kernels.attention import (  # noqa: E402
    FlashAttention, attention_bwd, attention_fwd)

SHAPE = (1, 2, 256)   # B patches, H heads, K tokens: two of the JAX kernel's
                      # 128-blocks each way


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call in TPU interpret mode, for this test only."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def _qkv(d, seed):
    rng = np.random.default_rng(seed)
    q = 2.0 * rng.normal(size=SHAPE + (d,))  # logits beyond N(0, 1)
    k, v = rng.normal(size=(2,) + SHAPE + (d,))
    return [x.astype(np.float32) for x in (q, k, v)]


def _jax_flash(q, k, v, scale):
    """The JAX package's call: d zero-padded to 128, sliced back."""
    d = q.shape[-1]
    pad = ((0, 0),) * 3 + ((0, 128 - d),)
    o = fa.flash_attention(*(jnp.pad(x, pad) for x in (q, k, v)),
                           sm_scale=scale)
    return o[..., :d]


@pytest.mark.parametrize("d", [16, 24, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fwd_matches_jax_flash_kernel(interpret, d, dtype):
    """o within 2e-6 of its largest magnitude in float32 (the two sum in
    different orders); in bfloat16 within 1e-2 of it: both round P to
    bfloat16 before P V and round o to bfloat16, so the float32 orders'
    differences flip a bfloat16 rounding here and there (one bf16 ulp is
    2^-8 relative, 3.9e-3)."""
    q, k, v = _qkv(d, seed=d)
    scale = d ** -0.5
    ref = _jax_flash(*(jnp.asarray(x, dtype) for x in (q, k, v)), scale)
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    o, lse = attention_fwd(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                           scale)
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == SHAPE
    tol = 2e-6 if dtype == "float32" else 1e-2
    err = np.abs(o.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), err
    # lse is the row's log-sum-exp of the scaled float32 logits
    s = np.einsum("bhqc,bhkc->bhqk", *(torch.from_numpy(x).to(tdt).double()
                                       .numpy() for x in (q, k))) * scale
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [16, 24, 32])
def test_flash_attention_grads_match_jax_flash_kernel(interpret, d):
    """dq, dk, dv of FlashAttention (the plain backward on the CPU) against
    jax.grad through the JAX flash kernel's own backward (its dK/dV and dQ
    kernels), float32, a random cotangent: each within 1e-5 of its largest
    magnitude. The two recompute P from different residuals (l and m
    there, lse here) and sum in different orders; they differ by ~1e-6."""
    q, k, v = _qkv(d, seed=10 + d)
    g = np.random.default_rng(20 + d).normal(size=q.shape).astype(np.float32)
    scale = d ** -0.5
    ref = jax.grad(lambda *a: jnp.sum(_jax_flash(*a, scale) * g),
                   argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(tq, tk, tv, scale)
    out.backward(torch.from_numpy(g))
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err)


def test_flash_attention_grads_match_autograd_in_float64():
    """The plain forward and backward against PyTorch autograd of softmax
    attention in float64 (float32 inputs, so the only differences are the
    port's float32 rounding): o and each gradient within 1e-5 of its
    largest magnitude."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(24, seed=3))
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=q.shape).astype(np.float32))
    scale = 24 ** -0.5
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    ref = torch.softmax(leaves[0] @ leaves[1].transpose(-1, -2) * scale,
                        -1) @ leaves[2]
    ref.backward(g.double())
    ref = ref.detach()
    o, lse = attention_fwd(q, k, v, scale)
    assert float((o - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())
    grads = attention_bwd(q, k, v, o, lse, g, scale)
    for got, leaf in zip(grads, leaves):
        want = leaf.grad
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 2, 128, 8), torch.float32, "head width"),
    ((1, 2, 100, 16), torch.float32, "multiple of 64"),
    ((1, 2, 128, 16), torch.float16, "float32 or all bfloat16"),
])
def test_attention_wrappers_refuse_what_the_kernels_do_not_take(shape, dtype,
                                                                match):
    """The same refusal on every device: a model that runs on the CPU also
    launches on the card."""
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        attention_fwd(x, x, x, 1.0)
    lse = torch.zeros(shape[:3])
    with pytest.raises(ValueError, match=match):
        attention_bwd(x, x, x, x, lse, x, 1.0)
