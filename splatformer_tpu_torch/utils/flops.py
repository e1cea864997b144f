"""FLOPs accounting (port of splatformer_tpu/utils/flops.py).

Two counts:

  * ``ptv3_attention_mlp_gflops``: the analytic attention and MLP FLOPs of
    every PTv3 block, from the per-stage point counts of one forward (the
    backbone's diagnostics, ``stage_points_from_diagnostics``) and the merge
    config. It counts what the reference's fvcore hooks count (qkv, the two
    attention products, proj, the MLP; one multiply-add is one FLOP), and
    it is the count that ``gflops.csv`` holds.
  * ``torch_flop_counter``: a whole-forward count under
    ``torch.utils.flop_counter.FlopCounterMode`` (two FLOPs a multiply-add),
    the counterpart of the JAX package's XLA cost analysis, which has no
    XLA under torch. It sees only the aten operators it knows: not the
    hand-written kernels, so on the ``enable_flash`` path K3's attention
    FLOPs are missing from it, and not the gathers and sorts. It is
    reported under its own name and compared with nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from splatformer_tpu_torch.ops.merging import merge_count


def torch_flop_counter(fn: Callable[..., Any], *args, **kwargs) -> float:
    """FLOPs that FlopCounterMode counts in ``fn(*args, **kwargs)``."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _merge_kprime(patch: int, info: Dict[str, Any]) -> int:
    """Tokens a patch keeps in the attention's products."""
    mode = (info or {}).get("tome", "base")
    r = float((info or {}).get("r", 0.0) or 0.0)
    if (mode in ("base", None, "none") or r <= 0
            or not (info or {}).get("tome_attention", True)):
        return patch
    if mode == "algm":
        # ALGM keeps K' = K and masks the merged-away slots
        # (ops/merging.py): the products stay at K; the live-token count
        # comes from the attention replay (n_effective_tokens)
        return patch
    return patch - merge_count(patch, r)


def block_attention_flops(n_points: float, channels: int, num_heads: int,
                          patch: int, info: Dict[str, Any]) -> float:
    """FLOPs of one SerializedAttention on n_points, one multiply-add one
    FLOP (fvcore's convention, which the reference's numbers use)."""
    c = channels
    ch = c // num_heads
    kp = _merge_kprime(patch, info)
    b = max(1.0, n_points / patch)
    qkv = n_points * c * 3 * c
    attn = b * num_heads * (kp * kp * ch) * 2  # q@k^T and attn@v
    proj = n_points * c * c
    return qkv + attn + proj


def block_mlp_flops(n_points: float, channels: int,
                    mlp_ratio: float = 4.0) -> float:
    return n_points * channels * int(channels * mlp_ratio) * 2


def ptv3_attention_mlp_gflops(
    backbone_kwargs: Dict[str, Any],
    stage_points: Dict[str, float],
    info: Dict[str, Any],
) -> Tuple[float, float]:
    """(attention GFLOPs, MLP GFLOPs) summed over all encoder and decoder
    blocks. stage_points: {'enc0': n, ..., 'dec0': n, ...}."""
    bk = backbone_kwargs
    attn_total, mlp_total = 0.0, 0.0
    for s, depth in enumerate(bk["enc_depths"]):
        n = float(stage_points.get(f"enc{s}", 0.0))
        for _ in range(depth):
            attn_total += block_attention_flops(
                n, bk["enc_channels"][s], bk["enc_num_head"][s],
                bk["enc_patch_size"][s], info)
            mlp_total += block_mlp_flops(n, bk["enc_channels"][s],
                                         bk.get("mlp_ratio", 4.0))
    for s, depth in enumerate(bk["dec_depths"]):
        n = float(stage_points.get(f"dec{s}", 0.0))
        for _ in range(depth):
            attn_total += block_attention_flops(
                n, bk["dec_channels"][s], bk["dec_num_head"][s],
                bk["dec_patch_size"][s], info)
            mlp_total += block_mlp_flops(n, bk["dec_channels"][s],
                                         bk.get("mlp_ratio", 4.0))
    return attn_total / 1e9, mlp_total / 1e9


def stage_points_from_diagnostics(diag: Dict[str, Any]) -> Dict[str, float]:
    """{'enc{s}': n, 'dec{s}': n} from a forward's diagnostics (device
    tensors or numbers; reading a tensor synchronises with its device)."""
    out = {}
    for k, v in diag.items():
        if k.startswith("enc") and k.endswith("_n_valid"):
            out[k.replace("_n_valid", "")] = float(v)
    for k, v in diag.get("intermediates", {}).items():
        out[k] = float(v["n_valid"])
    return out
