"""Token merging beside the ``enable_flash`` path, a tiny FeaturePredictor
against the JAX package's on the CPU (its Pallas flash kernel in TPU
interpret mode), eval mode, same weights: with ``tome_attention`` off the
attention stays at the full patch on K3 (its plain version here) in every
block while tome_mlp merges the MLP's tokens; with merging in the
attention, the JAX package falls back to its einsum path at the reduced K'
and the port to its plain matmul-softmax, and K3 is never called. Refined
attributes within 1e-4, PSNR within 1e-3 dB, SSIM within 1e-4."""
import functools

import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.experimental.pallas.ops.tpu import flash_attention as fa  # noqa: E402

from splatformer_tpu_torch.kernels import attention  # noqa: E402
from test_torch_merge_model import check_config, infos  # noqa: E402

# head widths 16, 24 and 32 (the three of PTv3-base), patch 128: 5 blocks
TINY_FLASH = dict(
    enc_depths=(1, 1, 1), enc_channels=(32, 48, 64), enc_num_head=(2, 2, 2),
    enc_patch_size=(128,) * 3, dec_depths=(1, 1), dec_channels=(32, 48),
    dec_num_head=(2, 2), dec_patch_size=(128,) * 2, stride=(1, 2),
    drop_path=0.0, pool_capacity_factors=(1.0, 0.75), use_flash=True,
)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _count(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("tome_attention", [False, True],
                         ids=["mlp_only", "in_attention"])
def test_merging_beside_flash(monkeypatch, tome_attention):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    jax_flash = _count(monkeypatch, fa, "flash_attention")
    port_k3 = _count(monkeypatch, attention, "attention_fwd_plain")
    info = dict(infos("ptv3_tome"), r=0.5, tome_attention=tome_attention)
    model = check_config(info, TINY_FLASH, TINY_FLASH)
    # once a block a forward; check_config runs the port's forward twice
    # (alone, then in the eval step)
    blocks = 0 if tome_attention else 5
    assert len(jax_flash) == blocks and len(port_k3) == 2 * blocks
    assert all(b.use_flash for b in model.modules()
               if type(b).__name__ == "SerializedAttention")
