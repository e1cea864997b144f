"""FLOP and byte counters and the table of peaks: the yardstick of the
``*_roofline`` and ``mfu*`` metrics.

* The attention and MLP count is a frozen copy of
  splatformer_tpu_torch/utils/flops.py (one multiply-add one FLOP, the
  convention behind ``gflops.csv``).
* ``model_flops`` is the count the ``mfu`` metrics use, two FLOPs a
  multiply-add, split by the precision class each term runs in: the
  blocks' dense products (qkv, proj, the MLP, the xCPE convolution over the
  neighbour pairs its kernel map holds, the xCPE Linear), the dense
  products outside the blocks (the embedding, the pooling and unpooling
  projections, the heads) and the attention's two products. Point counts
  are the live ones of each stage, so the count is the work the algorithm
  needs, not the padded work the program launches.
* ``k3_bound`` is a frozen copy of chip_smoke.py's K3 bound.
* ``fps_work`` and ``nearest_work`` count the operations and bytes of input
  downsampling's farthest-point sampling and nearest-centroid search
  (reference/downsample.py's formulas), functions of the shapes alone.

With input downsampling the backbone runs on the reduced set: K3's calls
take ``backbone_rows`` rows, the blocks and the embedding the stage points
they are given, and the heads the scene's live points.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from perfbench.reference.downsample import backbone_rows

# published NVIDIA H100 SXM peaks (dense): tensor-core bfloat16 and TF32,
# float32 outside the tensor cores, HBM3 bytes
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# TF32 products a float32-accurate product (split TF32), as K3's float32
# path computes it
TF32_SPLIT = 3
# exponentials on the SFU: 16 a clock per SM x 132 SMs x 1.98 GHz
PEAK_EXP = 16 * 132 * 1.98e9


# -- frozen copy of splatformer_tpu_torch/utils/flops.py ----------------------

def merge_count(k: int, r: float) -> int:
    """Tokens a patch of ``k`` merges away at rate ``r``: int(k r), capped
    at k // 2."""
    return max(0, min(k // 2, int(k * r)))


def _merge_kprime(patch: int, info: Dict[str, Any]) -> int:
    """Tokens a patch keeps in the attention's products."""
    mode = (info or {}).get("tome", "base")
    r = float((info or {}).get("r", 0.0) or 0.0)
    if (mode in ("base", None, "none") or r <= 0
            or not (info or {}).get("tome_attention", True)):
        return patch
    if mode == "algm":
        return patch
    return patch - merge_count(patch, r)


def block_attention_flops(n_points: float, channels: int, num_heads: int,
                          patch: int, info: Dict[str, Any]) -> float:
    """FLOPs of one SerializedAttention on n_points, one multiply-add one
    FLOP."""
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


def ptv3_attention_mlp_gflops(backbone_kwargs: Dict[str, Any],
                              stage_points: Dict[str, float],
                              info: Dict[str, Any]) -> Tuple[float, float]:
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


# -- the mfu count -------------------------------------------------------------

def _stage_blocks(bk: Dict[str, Any]) -> List[Tuple[str, int, int, int, int]]:
    """(stage key, stage index, channels, heads, patch) of every block."""
    out = []
    for s, depth in enumerate(bk["enc_depths"]):
        out += [(f"enc{s}", s, bk["enc_channels"][s], bk["enc_num_head"][s],
                 bk["enc_patch_size"][s])] * depth
    for s, depth in enumerate(bk["dec_depths"]):
        out += [(f"dec{s}", s, bk["dec_channels"][s], bk["dec_num_head"][s],
                 bk["dec_patch_size"][s])] * depth
    return out


def model_flops(bk: Dict[str, Any], heads: Dict[str, Any],
                stage_points: Dict[str, float], stage_pairs: Sequence[float],
                info: Dict[str, Any], live: float) -> Dict[str, float]:
    """Forward FLOPs (two a multiply-add) of one FeaturePredictor call, by
    class: ``block_dense``, ``outside_dense``, ``attn_products``.

    ``stage_points``: live points {'enc{s}': n, 'dec{s}': n} (with input
    downsampling, those of the reduced set); ``stage_pairs[s]``: live
    (point, offset) pairs of stage s's kernel map; ``live``: the scene's
    live points, at which the heads run (without downsampling, ``enc0``'s);
    ``heads``: {in_channels, width, nlayer, out_channels:
    [..]}. With token merging the attention's products run at K' tokens a
    patch and, with ``tome_mlp``, the MLP on the merged tokens."""
    mlp_ratio = bk.get("mlp_ratio", 4.0)
    block_dense = attn_products = 0.0
    for key, s, c, h, patch in _stage_blocks(bk):
        n = float(stage_points.get(key, 0.0))
        kp = _merge_kprime(patch, info)
        b = max(1.0, n / patch)
        attn_products += 2 * b * h * kp * kp * (c // h) * 2
        mlp_tokens = n
        if (kp < patch and (info or {}).get("tome_mlp")):
            mlp_tokens = n * kp / patch
        block_dense += 2 * (n * c * 3 * c + n * c * c            # qkv, proj
                            + mlp_tokens * c * int(c * mlp_ratio) * 2
                            + float(stage_pairs[s]) * c * c      # xCPE conv
                            + n * c * c)                         # xCPE Linear
    enc, dec = bk["enc_channels"], list(bk["dec_channels"]) + [
        bk["enc_channels"][-1]]
    n0 = float(stage_points["enc0"])
    outside = 2 * n0 * heads["in_channels"] * enc[0]              # embedding
    for s in range(1, len(enc)):                                  # pooling
        outside += 2 * float(stage_points[f"enc{s - 1}"]) * enc[s - 1] * enc[s]
    for s in range(len(enc) - 1):                                 # unpooling
        child = float(stage_points[f"enc{s + 1}"])
        outside += 2 * (child * dec[s + 1] * dec[s]
                        + float(stage_points[f"enc{s}"]) * enc[s] * dec[s])
    head_in = dec[0] + heads["in_channels"]
    w, layers = heads["width"], heads["nlayer"]
    for out in heads["out_channels"]:
        outside += 2 * float(live) * (head_in * w + (layers - 2) * w * w
                                  + w * out)
    return {"block_dense": block_dense, "outside_dense": outside,
            "attn_products": attn_products}


VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def lpips_flops(n_images: int, height: int, width: int) -> float:
    """Forward FLOPs (two a multiply-add) of LPIPS's VGG16 convolutions on
    ``n_images`` images (3x3, stride 1, 'same'; 2x2 pooling between
    stages)."""
    total, cin, h, w = 0.0, 3, height, width
    for si, (ch, convs) in enumerate(VGG_STAGES):
        for _ in range(convs):
            total += 2 * n_images * h * w * 9 * cin * ch
            cin = ch
        if si < len(VGG_STAGES) - 1:
            h, w = h // 2, w // 2
    return total


# -- K3 ------------------------------------------------------------------------

def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def k3_calls(bk: Dict[str, Any], rows: int
             ) -> List[Tuple[int, int, int, int]]:
    """(B patches, H heads, d, K tokens a patch) of every K3 call of one
    forward, in block order, from the rows the backbone runs on
    (``backbone_rows``) and the pooled capacities of PTv3's forward
    (models/ptv3.py)."""
    enc_p, dec_p = bk["enc_patch_size"], bk["dec_patch_size"]
    caps = [rows]
    for s in range(1, len(bk["enc_depths"])):
        mult = max(enc_p[s], dec_p[min(s, len(dec_p) - 1)])
        cap = _round_up(max(mult, int(caps[-1]
                                      * bk["pool_capacity_factors"][s - 1])),
                        mult)
        caps.append(min(cap, _round_up(caps[-1], mult)))
    return [(caps[s] // patch, h, c // h, patch)
            for key, s, c, h, patch in _stage_blocks(bk)]


def k3_bound(b: int, h: int, d: int, bf16: bool, backward: bool,
             patch: int) -> Tuple[float, float, float, float, float]:
    """(ops s, bytes s, FLOPs, exponentials, bytes) of the least work of one
    K3 call (chip_smoke.py:k3_bound) over patches of K = ``patch`` tokens:
    forward 4 K^2 d FLOP a head, backward 2.5 times that, one exponential a
    (query, key) pair; each input read once and each output written once.
    FLOPs on the tensor cores: bfloat16 at its peak, float32 as TF32_SPLIT
    TF32 products at the TF32 peak; exponentials at the SFU rate."""
    pairs = b * h * patch ** 2
    flops = (10 if backward else 4) * pairs * d
    tokens = b * h * patch
    esize = 2 if bf16 else 4
    nbytes = (8 if backward else 4) * tokens * d * esize + 4 * tokens
    tensor_s = flops / PEAK_BF16 if bf16 else TF32_SPLIT * flops / PEAK_TF32
    ops_s = max(tensor_s, pairs / PEAK_EXP)
    return ops_s, nbytes / PEAK_BYTES, flops, pairs, nbytes


def k3_forward_bound_s(bk: Dict[str, Any], rows: int, bf16: bool,
                       backward: bool) -> float:
    """The least time of one forward's (or backward's) K3 calls on
    ``rows`` backbone rows, each call bound by the larger of its operations
    and its bytes."""
    return sum(max(k3_bound(b, h, d, bf16, backward, k)[:2])
               for b, h, d, k in k3_calls(bk, rows))


# -- input downsampling --------------------------------------------------------

def fps_work(n: int, m: int) -> Tuple[float, float]:
    """(FP32 operations, bytes) of farthest-point sampling ``m`` of ``n``
    points (reference/downsample.py:furthest_point_sampling).

    Each of the m steps runs over all n points: ``coord - c`` (3 n
    subtractions), ``.square()`` (3 n multiplications), ``.sum(dim=1)`` (2 n
    additions), the running ``minimum`` (n comparisons) and ``argmax`` (n
    comparisons): 10 n operations a step, 10 n m in all. Bytes: each input
    read once, the coordinates (12 n) and the mask (n), and the output
    written once, m int64 indices (8 m)."""
    return 10.0 * n * m, 13.0 * n + 8.0 * m


def nearest_work(n: int, m: int) -> Tuple[float, float]:
    """(FP32 operations, bytes) of the nearest of ``m`` references for each
    of ``n`` queries (reference/downsample.py:nearest_idx).

    The squared norms ``(x * x).sum(dim=1)``: 3 multiplications and 2
    additions a row, 5 (n + m). For each (query, reference) pair: ``q @
    refs.T`` (3 multiply-adds, 6 operations), ``2.0 *`` and the subtraction
    (2), ``+ ref2`` and ``+ big`` (2) and ``argmin`` (1 comparison): 11 n m.
    Bytes: each input read once, the queries (12 n), the references (12 m)
    and their mask (m), and the output written once, n int64 indices
    (8 n)."""
    return 11.0 * n * m + 5.0 * (n + m), 20.0 * n + 13.0 * m


def fps_bound_s(n: int, m: int) -> float:
    """The least time of ``fps_work``: the larger of its operations at the
    FP32 peak and its bytes at HBM's bandwidth."""
    ops, nbytes = fps_work(n, m)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def nearest_bound_s(n: int, m: int) -> float:
    """The least time of ``nearest_work``, as ``fps_bound_s``."""
    ops, nbytes = nearest_work(n, m)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
