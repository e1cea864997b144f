"""Point Transformer V3 backbone (port of splatformer_tpu/models/ptv3.py).

Block = xCPE (3^3 submanifold conv -> Linear -> BN, residual) -> LN ->
serialized patch attention -> residual -> LN -> MLP -> residual.
Serialized pooling clusters points by right-shifted SFC codes (segment max
of the projected features), unpooling broadcasts back through the cluster
map and adds the projected skip. Every stage has a static point capacity,
with overflow clusters dropped into a waste bucket, as in the reference.

Training uses the masked batch statistics, DropPath (rates linspace(0,
drop_path, depth), each decoder stage's slice reversed) drawn from the
caller's generator, and, with ``compute_dtype`` set, mixed precision inside
the blocks only: the block input is cast to it, the conv, Linear and
attention matmuls run in it, softmax, LayerNorm and BatchNorm statistics
run in float32 with outputs in the compute dtype, and the residual stream
leaves the block in the block's input dtype. Evaluation is float32. Blocks
are not rematerialised: the JAX package remats them only to fit a TPU
v5e's 16 GB.

Token merging (ops/merging.py, the ``additional_info`` of the
``model_ptv3_*`` configs) runs inside the attention when ``tome_attention``
holds, with the keys as the metric and the proportional-attention bias
log(size) on the logits, at the reduced K' through the plain matmul-softmax
(never K3: the JAX package's flash path falls back to its einsum there
too); and, with ``tome_mlp``, as a second, independent merge of the
serialized MLP input (one head). ``turn_off_bn`` makes every BatchNorm the
identity; ``embedding_type="PT_embedding"`` is a 3^3 submanifold-conv stem
in place of the Linear one.

Diagnostics, as the JAX backbone returns them: given a ``diagnostics``
dict, the forward fills ``enc{s}_n_valid`` after each encoder stage and
``intermediates`` -> ``dec{s}`` -> ``{feat, code, n_valid}`` after each
decoder stage (``code``: the first order's codes), all device tensors.
``capture_attention`` records what the JAX attention sows for the replay
(utils/attn_replay.py): the normalised input of ``qkv``, the padded order,
its inverse, the coordinates, and the output after the inverse and before
``proj``. Both are off unless asked for, and then cost one test each and
neither a launch nor a host synchronisation.

Module and parameter names follow the flax model's, so data/convert.py maps
a JAX checkpoint one to one. LayerNorm eps is flax's 1e-6 and GELU is the
tanh approximation, as flax's defaults.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from splatformer_tpu_torch import tracing
from splatformer_tpu_torch.kernels.attention import FlashAttention
from splatformer_tpu_torch.models.layers import (DropPath, MaskedBatchNorm,
                                                 Mlp, linear)
from splatformer_tpu_torch.models.point import PointBatch
from splatformer_tpu_torch.ops import merging
from splatformer_tpu_torch.ops.segment_ops import (pad_order_for_patches,
                                                   segment_max, segment_mean)
from splatformer_tpu_torch.ops.serialization import (INVALID_CODE, ORDERS,
                                                     inverse_permutation)
from splatformer_tpu_torch.ops.sparse_conv import (build_neighbor_map,
                                                   sparse_conv_apply)

_INT32_MAX = 2 ** 31 - 1
LN_EPS = 1e-6  # flax nn.LayerNorm's default


def merging_requested(additional_info: Optional[Dict[str, Any]]) -> bool:
    info = additional_info or {}
    return (info.get("tome", "base") not in ("base", None, "none")
            and float(info.get("r", 0.0) or 0.0) > 0.0)


class SerializedAttention(nn.Module):
    """Attention within fixed-size patches of one serialized order: gather
    by the (padded) order, batched softmax attention (softmax in f32),
    scatter back. With ``use_flash`` (the ``enable_flash`` configurations,
    patch 1024) the attention is K3, ``FlashAttention`` over (B, H, K, d)
    with ``scale`` on the logits, as the JAX package's Pallas flash path;
    otherwise plain matmuls and softmax, as its einsum path, which XLA
    computes outside any kernel. Token merging in the attention
    (``additional_info``) takes the plain path at the reduced K', with
    log(size) added over the key axis, then unmerges the output."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int, use_flash: bool = False,
                 additional_info: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.order_index = order_index
        self.use_flash = use_flash
        info = additional_info or {}
        self.merge_info = (info if merging_requested(info)
                           and info.get("tome_attention", True) else None)
        self.scale = (channels // num_heads) ** -0.5
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)
        # capture_attention's dict while it records, else None
        self.record: Optional[Dict[str, torch.Tensor]] = None

    def forward(self, feat: torch.Tensor, pb: PointBatch,
                dtype: Optional[torch.dtype] = None,
                uniform: Optional[merging.Uniform] = None) -> torch.Tensor:
        n, c = feat.shape
        k, h = self.patch_size, self.num_heads
        if n % k:
            raise ValueError(f"{n} points are not whole patches of {k}")
        order = pad_order_for_patches(pb.order_perm[self.order_index],
                                      pb.n_valid, k)
        inverse = pb.inverse_perm[self.order_index]
        # index_select, not advanced indexing: its backward is an
        # index_add_, where the indexing backward sorts
        qkv = linear(self.qkv, feat, dtype).index_select(0, order.long())
        qkv = qkv.reshape(n // k, k, 3, h, c // h)
        q, kk, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)     # (B, H, K, ch)
        unmerge = None
        if self.merge_info is not None:
            info = self.merge_info
            with tracing.span("attention.merge"):
                q, kk, v, size, unmerge = merging.process_merging(
                    info["tome"], q, kk, v, info, uniform)
        if self.use_flash and unmerge is None:
            out = FlashAttention.apply(q, kk, v, self.scale)
        else:
            # logits and softmax in f32 (the JAX einsum's
            # preferred_element_type)
            attn = torch.matmul((q * self.scale).float(),
                                kk.transpose(-1, -2).float())
            if unmerge is not None:
                # proportional attention over the keys: a key standing for
                # s tokens gets +log(s); size 0 (ALGM's dead slots) masks it
                attn = attn + torch.log(torch.clamp(
                    size[..., 0], min=1e-30))[..., None, :]
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            out = torch.matmul(attn, v)
        if unmerge is not None:
            with tracing.span("attention.unmerge"):
                out = unmerge(out)                      # back to (B, H, K, ch)
        out = out.permute(0, 2, 1, 3).reshape(n, c).index_select(
            0, inverse.long())
        if self.record is not None:
            self.record.update(attn_feat=out, attn_in=feat, attn_order=order,
                               attn_inverse=inverse, attn_coord=pb.coord)
        return linear(self.proj, out, dtype)


@contextlib.contextmanager
def capture_attention(model: nn.Module
                      ) -> Iterator[Dict[str, Dict[str, torch.Tensor]]]:
    """Record, for the forwards inside the ``with``, every
    SerializedAttention's ``attn_in``, ``attn_order``, ``attn_inverse``,
    ``attn_coord`` and ``attn_feat`` (the JAX module's sown
    intermediates). Yields {path: record}, each path in the JAX form
    (``backbone/enc0_block0/attn`` under a FeaturePredictor); a later
    forward overwrites an earlier one's records."""
    records: Dict[str, Dict[str, torch.Tensor]] = {}
    mods = [(name, m) for name, m in model.named_modules()
            if isinstance(m, SerializedAttention)]
    for name, m in mods:
        m.record = records.setdefault(name.replace(".", "/"), {})
    try:
        yield records
    finally:
        for _, m in mods:
            m.record = None


class Block(nn.Module):
    """xCPE + pre-LN attention + pre-LN MLP with droppath residuals; with
    ``tome_mlp`` and merging requested, the MLP runs on the tokens of an
    independent merge of its serialized input's patches (one head)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int, drop_path: float, mlp_ratio: float = 4.0,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_flash: bool = False, turn_off_bn: bool = False,
                 additional_info: Optional[Dict[str, Any]] = None,
                 bn_group=None):
        super().__init__()
        c = channels
        self.compute_dtype = compute_dtype
        self.patch_size = patch_size
        self.order_index = order_index
        info = additional_info or {}
        self.mlp_merge_info = (info if merging_requested(info)
                               and info.get("tome_mlp") else None)
        # (27, Cin, Cout) in conv_offsets' row-major order, as the JAX param
        self.cpe_conv_kernel = nn.Parameter(torch.empty(27, c, c))
        self.cpe_conv_bias = nn.Parameter(torch.zeros(c))
        self.cpe_linear = nn.Linear(c, c)
        self.cpe_norm = MaskedBatchNorm(c, off=turn_off_bn, group=bn_group)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = SerializedAttention(c, num_heads, patch_size, order_index,
                                        use_flash, additional_info)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = Mlp(c, int(c * mlp_ratio), c)
        self.drop_path = DropPath(drop_path)

    def _layer_norm(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        """Statistics and affine in float32, output in x's dtype."""
        y = F.layer_norm(x.to(torch.float32), norm.normalized_shape,
                         norm.weight, norm.bias, norm.eps)
        return y.to(x.dtype)

    def _merged_mlp(self, h: torch.Tensor, pb: PointBatch,
                    dt: Optional[torch.dtype],
                    uniform: Optional[merging.Uniform]) -> torch.Tensor:
        """The MLP on merged tokens: gather by the padded order, merge each
        patch (H = 1), MLP, unmerge, scatter back."""
        n, c = h.shape
        k, info = self.patch_size, self.mlp_merge_info
        order = pad_order_for_patches(pb.order_perm[self.order_index],
                                      pb.n_valid, k)
        inverse = pb.inverse_perm[self.order_index]
        hseq = h.index_select(0, order.long()).reshape(n // k, 1, k, c)
        with tracing.span("mlp.merge"):
            merge, unmerge, _ = merging.build_merge(info["tome"], hseq, info,
                                                    uniform)
            tok = merge(hseq)
        m = self.mlp(tok.reshape(-1, c), dt).reshape(tok.shape[:-1] + (-1,))
        with tracing.span("mlp.unmerge"):
            m = unmerge(m)
        return m.reshape(n, -1).index_select(0, inverse.long())

    def forward(self, pb: PointBatch, nbr: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[merging.Uniform] = None) -> PointBatch:
        dt = self.compute_dtype if self.training else None
        feat = pb.feat if dt is None else pb.feat.to(dt)
        h = sparse_conv_apply(feat, nbr, self.cpe_conv_kernel.to(feat.dtype),
                              self.cpe_conv_bias.to(feat.dtype))
        feat = feat + self.cpe_norm(linear(self.cpe_linear, h, dt), pb.mask)
        h = self.attn(self._layer_norm(self.norm1, feat), pb, dt, uniform)
        feat = feat + self.drop_path(h, generator)
        h = self._layer_norm(self.norm2, feat)
        if self.mlp_merge_info is not None:
            h = self._merged_mlp(h, pb, dt, uniform)
        else:
            h = self.mlp(h, dt)
        feat = feat + self.drop_path(h, generator)
        return pb.replace(feat=feat.to(pb.feat.dtype))


class SerializedPooling(nn.Module):
    """Grid pooling by right-shifted SFC codes of the first order. Returns the
    pooled PointBatch (capacity ``child_capacity``) and the cluster map
    (waste bucket = child_capacity) for unpooling."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 turn_off_bn: bool = False, bn_group=None):
        super().__init__()
        self.pooling_depth = max(0, int(math.ceil(math.log2(stride))))
        self.proj = nn.Linear(in_channels, out_channels)
        self.norm = MaskedBatchNorm(out_channels, off=turn_off_bn,
                                    group=bn_group)

    def forward(self, pb: PointBatch, child_capacity: int
                ) -> Tuple[PointBatch, torch.Tensor]:
        n, m = pb.num_points, child_capacity
        dev = pb.feat.device
        depth = self.pooling_depth
        shift = depth * 3

        sorted_idx = pb.order_perm[0].to(torch.int64)
        sorted_codes = pb.codes[0][sorted_idx]
        valid_sorted = torch.arange(n, device=dev) < pb.n_valid
        shifted = torch.where(valid_sorted, sorted_codes >> shift,
                              torch.full_like(sorted_codes, _INT32_MAX))
        prev = torch.cat([shifted.new_full((1,), -1), shifted[:-1]])
        is_head = valid_sorted & (shifted != prev)
        cid_sorted = torch.cumsum(is_head, 0) - 1
        n_clusters = is_head.sum()
        # overflow and invalid points -> waste bucket m
        cid_sorted = torch.where(valid_sorted & (cid_sorted < m), cid_sorted,
                                 torch.full_like(cid_sorted, m))
        cluster = torch.empty_like(cid_sorted).scatter_(0, sorted_idx,
                                                        cid_sorted)

        pf = self.proj(pb.feat)
        child_feat = segment_max(pf, cluster, m + 1)[:m]
        child_coord = segment_mean(pb.coord, cluster, m + 1)[:m]

        # the head point of each cluster carries grid_coord and codes; the
        # waste slot m takes every other write and is cut off
        head_target = torch.where(is_head & (cid_sorted < m), cid_sorted,
                                  torch.full_like(cid_sorted, m))
        head_point = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        head_point = head_point.index_put_((head_target,), sorted_idx)[:m]
        child_grid = pb.grid_coord[head_point] >> depth
        child_codes = pb.codes[:, head_point] >> shift

        child_n_valid = torch.clamp(n_clusters, max=m).to(torch.int32)
        child_mask = torch.arange(m, device=dev) < child_n_valid
        child_codes = torch.where(child_mask[None, :], child_codes,
                                  torch.full_like(child_codes, INVALID_CODE))
        child_order = torch.sort(child_codes, dim=-1, stable=True).indices

        child_feat = F.gelu(self.norm(child_feat, child_mask),
                            approximate="tanh")
        child = PointBatch(
            coord=child_coord, grid_coord=child_grid, feat=child_feat,
            mask=child_mask, n_valid=child_n_valid, codes=child_codes,
            order_perm=child_order.to(torch.int32),
            inverse_perm=inverse_permutation(child_order))
        return child, cluster


class SerializedUnpooling(nn.Module):
    """Broadcast pooled features back through the cluster map and add the
    projected skip; waste-bucket clusters contribute zero."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, turn_off_bn: bool = False,
                 bn_group=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels)
        self.proj_norm = MaskedBatchNorm(out_channels, off=turn_off_bn,
                                         group=bn_group)
        self.proj_skip = nn.Linear(skip_channels, out_channels)
        self.proj_skip_norm = MaskedBatchNorm(out_channels, off=turn_off_bn,
                                              group=bn_group)

    def forward(self, child: PointBatch, parent: PointBatch,
                cluster: torch.Tensor) -> PointBatch:
        h = F.gelu(self.proj_norm(self.proj(child.feat), child.mask),
                   approximate="tanh")
        skip = F.gelu(self.proj_skip_norm(self.proj_skip(parent.feat),
                                          parent.mask), approximate="tanh")
        mc = child.feat.shape[0]
        up = h.index_select(0, torch.clamp(cluster, 0, mc - 1).long())
        keep = (cluster < mc) & parent.mask
        up = torch.where(keep[:, None], up, torch.zeros_like(up))
        return parent.replace(feat=skip + up)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _count_stage(stage: str, pb: PointBatch, pairs: torch.Tensor) -> None:
    """The tracer's counters of one stage: the slots its blocks run over,
    its live points and its kernel map's live pairs."""
    tracing.count(f"refine.rows.{stage}", pb.num_points)
    tracing.count(f"refine.points.{stage}", pb.n_valid)
    tracing.count(f"refine.pairs.{stage}", pairs)


class PointTransformerV3(nn.Module):
    """The U-Net backbone. The embedding is Linear -> BN -> GELU ("MLP") or
    a 3^3 submanifold conv -> BN -> GELU ("PT_embedding"; the reference's
    stem is 5^3, the JAX package's 3^3). Defaults are PTv3-base's."""

    def __init__(
        self,
        in_channels: int,
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (64, 96, 128, 256, 512),
        enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
        enc_patch_size: Sequence[int] = (128, 128, 128, 128, 128),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        dec_channels: Sequence[int] = (96, 96, 128, 256),
        dec_num_head: Sequence[int] = (4, 4, 8, 16),
        dec_patch_size: Sequence[int] = (128, 128, 128, 128),
        stride: Sequence[int] = (1, 2, 2, 2),
        mlp_ratio: float = 4.0,
        drop_path: float = 0.3,
        pool_capacity_factors: Sequence[float] = (1.0, 0.75, 0.625, 0.5),
        compute_dtype: Optional[torch.dtype] = None,
        use_flash: bool = False,
        turn_off_bn: bool = False,
        embedding_type: str = "MLP",
        additional_info: Optional[Dict[str, Any]] = None,
        bn_group=None,
    ):
        super().__init__()
        num_stages = len(enc_depths)
        if num_stages != len(stride) + 1:
            raise ValueError("need one stride per stage transition")
        self.enc_depths = tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.enc_patch_size = tuple(enc_patch_size)
        self.dec_patch_size = tuple(dec_patch_size)
        self.pool_capacity_factors = tuple(pool_capacity_factors)
        self.out_channels = (dec_channels[0] if num_stages > 1
                             else enc_channels[-1])

        enc_dp = [float(x) for x in np.linspace(0, drop_path, sum(enc_depths))]
        dec_dp = [float(x) for x in np.linspace(0, drop_path, sum(dec_depths))]

        self.embedding_type = embedding_type
        if embedding_type == "MLP":
            self.embed_linear = nn.Linear(in_channels, enc_channels[0])
        elif embedding_type == "PT_embedding":
            self.embed_conv_kernel = nn.Parameter(
                torch.empty(27, in_channels, enc_channels[0]))
            self.embed_conv_bias = nn.Parameter(torch.zeros(enc_channels[0]))
        else:
            raise NotImplementedError(f"embedding_type {embedding_type!r}")
        self.embed_norm = MaskedBatchNorm(enc_channels[0], off=turn_off_bn,
                                          group=bn_group)
        block_kw = dict(mlp_ratio=mlp_ratio, compute_dtype=compute_dtype,
                        use_flash=use_flash, turn_off_bn=turn_off_bn,
                        additional_info=additional_info, bn_group=bn_group)
        for s in range(num_stages):
            if s > 0:
                self.add_module(f"enc{s}_down", SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], stride[s - 1],
                    turn_off_bn, bn_group))
            dps = enc_dp[sum(enc_depths[:s]):sum(enc_depths[:s + 1])]
            for i in range(enc_depths[s]):
                self.add_module(f"enc{s}_block{i}", Block(
                    enc_channels[s], enc_num_head[s], enc_patch_size[s],
                    i % len(ORDERS), dps[i], **block_kw))
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        for s in reversed(range(num_stages - 1)):
            self.add_module(f"dec{s}_up", SerializedUnpooling(
                dec_ch[s + 1], enc_channels[s], dec_ch[s], turn_off_bn,
                bn_group))
            dps = dec_dp[sum(dec_depths[:s]):sum(dec_depths[:s + 1])][::-1]
            for i in range(dec_depths[s]):
                self.add_module(f"dec{s}_block{i}", Block(
                    dec_ch[s], dec_num_head[s], dec_patch_size[s],
                    i % len(ORDERS), dps[i], **block_kw))

    def _pool_capacity(self, s: int, n: int) -> int:
        """Stage ``s``'s point capacity, pooled from ``n`` slots: the
        capacity factor's share, whole patches of the stage's larger patch
        size, at least one patch and no more than ``n`` rounded up."""
        patch_mult = max(
            self.enc_patch_size[s],
            self.dec_patch_size[min(s, len(self.dec_patch_size) - 1)])
        cap = _round_up(
            max(patch_mult, int(n * self.pool_capacity_factors[s - 1])),
            patch_mult)
        return min(cap, _round_up(n, patch_mult))

    def forward(self, pb: PointBatch,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[merging.Uniform] = None,
                diagnostics: Optional[Dict[str, Any]] = None
                ) -> torch.Tensor:
        """``generator`` drives DropPath; ``uniform`` draws random_patch's
        block scores (training only; None takes the blocks in order);
        ``diagnostics``, when given, is filled with the stage counts and
        the decoder stages' outputs (the module docstring)."""
        num_stages = len(self.enc_depths)
        with tracing.span("refine.embed"):
            # stage 0's conv structure, shared by a PT_embedding stem
            nbr0 = build_neighbor_map(pb.grid_coord, pb.mask)
            if self.embedding_type == "MLP":
                h = self.embed_linear(pb.feat)
            else:
                h = sparse_conv_apply(pb.feat, nbr0, self.embed_conv_kernel,
                                      self.embed_conv_bias)
            h = F.gelu(self.embed_norm(h, pb.mask), approximate="tanh")
        pb = pb.replace(feat=h)

        skips, clusters, stage_nbrs, pairs = [], [], [], {}
        for s in range(num_stages):
            with tracing.span(f"refine.enc{s}"):
                if s > 0:
                    child, cluster = self.get_submodule(f"enc{s}_down")(
                        pb, self._pool_capacity(s, pb.num_points))
                    clusters.append(cluster)
                    skips.append(pb)
                    pb = child
                nbr = nbr0 if s == 0 else build_neighbor_map(pb.grid_coord,
                                                             pb.mask)
                stage_nbrs.append(nbr)
                if tracing.enabled():
                    pairs[s] = (nbr >= 0).sum()
                    _count_stage(f"enc{s}", pb, pairs[s])
                for i in range(self.enc_depths[s]):
                    pb = self.get_submodule(f"enc{s}_block{i}")(
                        pb, nbr, generator, uniform)
            if diagnostics is not None:
                diagnostics[f"enc{s}_n_valid"] = pb.n_valid

        intermediates = {}
        for s in reversed(range(num_stages - 1)):
            with tracing.span(f"refine.dec{s}"):
                pb = self.get_submodule(f"dec{s}_up")(pb, skips[s],
                                                      clusters[s])
                if tracing.enabled():
                    _count_stage(f"dec{s}", pb, pairs[s])
                for i in range(self.dec_depths[s]):
                    pb = self.get_submodule(f"dec{s}_block{i}")(
                        pb, stage_nbrs[s], generator, uniform)
            if diagnostics is not None:
                intermediates[f"dec{s}"] = {"feat": pb.feat,
                                            "code": pb.codes[0],
                                            "n_valid": pb.n_valid}
        if diagnostics is not None:
            diagnostics["intermediates"] = intermediates
        return pb.feat
