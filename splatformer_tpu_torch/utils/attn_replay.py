"""Per-head attention replay for the visualizer (port of
splatformer_tpu/utils/attn_replay.py; the reference's forward-hook path).

One eval forward under ``models/ptv3.py:capture_attention`` records each
attention block's input, padded order, inverse, coordinates and output;
the replay re-executes a block's attention from them with the module's own
qkv weights, head by head, with and without merging, and returns per-head
merged and base features, merged-token coordinates and random merge-group
colourings. Block paths take the JAX form (``backbone/enc0_block0/attn``)
and come in the JAX package's order (sorted), and the colours are drawn
from the same ``np.random.default_rng(seed)`` stream in the same order, so
both packages colour the same merge groups alike.

The replay is plain PyTorch in float32 on the recorded tensors' device
(matmuls, softmax, the merges of ops/merging.py), as the JAX replay is
plain ``jnp``: on the ``enable_flash`` path it holds K3's output against
plain products. Under bfloat16 block compute the comparison means nothing;
the tools run their models in evaluation, which is float32.

``trace_back`` (``additional_info``) traces the merge-group colourings
back through unmerge and the serialized inverse to the block's original
points (True), or reports them on the merged tokens (False, the reference
default).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from splatformer_tpu_torch.models.ptv3 import capture_attention
from splatformer_tpu_torch.ops import merging


def with_qkv(model, records: Dict[str, Dict[str, Any]]
             ) -> Dict[str, Dict[str, Any]]:
    """``capture_attention``'s records in the JAX package's order (sorted),
    those of blocks that did not run dropped, each with its module's
    ``qkv_kernel`` (C, 3C) and ``qkv_bias``."""
    blocks: Dict[str, Dict[str, Any]] = {}
    for path in sorted(p for p, rec in records.items() if rec):
        qkv = model.get_submodule(path.replace("/", ".")).qkv
        blocks[path] = {**records[path],
                        "qkv_kernel": qkv.weight.detach().t(),
                        "qkv_bias": qkv.bias.detach()}
    return blocks


def collect_attention_blocks(model, scene) -> Dict[str, Dict[str, Any]]:
    """One eval forward of ``model`` (a FeaturePredictor) on ``scene`` with
    capture on; returns {block_path: {attn_in, attn_order, attn_inverse,
    attn_coord, attn_feat, qkv_kernel, qkv_bias}} (``with_qkv``), tensors
    on the model's device."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(), capture_attention(model) as recs:
            model(scene)
    finally:
        model.train(was_training)
    return with_qkv(model, recs)


def head_count_for(path: str, backbone_kwargs: Dict[str, Any]) -> int:
    """enc{s}_block{i} / dec{s}_block{i} -> configured head count."""
    for part in path.split("/"):
        if part.startswith("enc") and "_block" in part:
            s = int(part[3:part.index("_")])
            return int(backbone_kwargs["enc_num_head"][s])
        if part.startswith("dec") and "_block" in part:
            s = int(part[3:part.index("_")])
            return int(backbone_kwargs["dec_num_head"][s])
    raise ValueError(f"cannot infer the head count of {path!r}")


def replay_block(rec: Dict[str, Any], num_heads: int, patch_size: int,
                 additional_info: Optional[Dict[str, Any]] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """Re-execute one block's serialized attention per head, with and
    without merging.

    Returns per-head lists of numpy arrays in the block's original point
    order:
      attn_feats[h]      (N, ch) merged-path attention features
      ori_attn_feats[h]  (N, ch) base-path attention features
      merged_coords[h]   token coords after merging (N, 3) traced back, or
                         (B K', 3) on the merged tokens
      merged_colors[h]   random merge-group colourings, same layout (None
                         unless merging ran)
    plus 'size' (B, H, K', 1) and the ints n_tokens, n_effective_tokens.
    """
    rng = rng or np.random.default_rng(0)
    info = dict(additional_info or {})
    feat = rec["attn_in"].float()
    order = rec["attn_order"].long()
    inverse = rec["attn_inverse"].long()
    n, c = feat.shape
    k, h = patch_size, num_heads
    ch = c // h
    scale = ch ** -0.5

    qkv = feat @ rec["qkv_kernel"].float() + rec["qkv_bias"].float()
    qkv = qkv.index_select(0, order).reshape(n // k, k, 3, h, ch)
    ori_q, ori_k, ori_v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    coords = rec["attn_coord"].float().index_select(0, order)
    coords = coords.reshape(n // k, 1, k, 3).expand(n // k, h, k, 3)

    def attend(q, kk, v, size=None):
        logits = torch.matmul(q * scale, kk.transpose(-1, -2))
        if size is not None:  # proportional attention over the keys
            logits = logits + torch.log(torch.clamp(
                size[..., 0], min=1e-30))[..., None, :]
        return torch.matmul(torch.softmax(logits, dim=-1), v)

    ori_feat = attend(ori_q, ori_k, ori_v)

    mode = info.get("tome", "base")
    r = float(info.get("r", 0.0) or 0.0)
    do_merge = (mode in merging.MERGE_MODES and r > 0.0
                and info.get("tome_attention", True))
    out: Dict[str, Any] = {"n_tokens": n}
    unmerge = None
    colors = None
    m_coords = coords
    if do_merge:
        merge, unmerge, size = merging.build_merge(mode, ori_k, info)
        q, kk, v = merge(ori_q), merge(ori_k), merge(ori_v)
        m_feat_full = unmerge(attend(q, kk, v, size))
        m_coords = merge(coords.contiguous())  # the same partition
        kp = v.shape[-2]
        # a random colour per merged token marks the merge groups
        colors = torch.as_tensor(rng.uniform(size=(n // k, h, kp, 3)),
                                 dtype=torch.float32).to(feat.device)
        size_np = size.cpu().numpy()
        out["size"] = size_np
        out["n_effective_tokens"] = int(np.sum(size_np > 0) / max(h, 1))
    else:
        m_feat_full = ori_feat
        out["size"] = None
        out["n_effective_tokens"] = n

    def per_head(x):
        return [x[:, i].reshape(-1, x.shape[-1]).index_select(0, inverse)
                .cpu().numpy() for i in range(h)]

    def per_head_tokens(x):
        return [x[:, i].reshape(-1, x.shape[-1]).cpu().numpy()
                for i in range(h)]

    out["attn_feats"] = per_head(m_feat_full)
    out["ori_attn_feats"] = per_head(ori_feat)
    if info.get("trace_back", False) and unmerge is not None:
        # unmerge broadcasts each merged token's colour and centroid to its
        # constituents; the serialized inverse restores the input order
        out["merged_colors"] = per_head(unmerge(colors))
        out["merged_coords"] = per_head(unmerge(m_coords))
    else:
        out["merged_colors"] = (None if colors is None
                                else per_head_tokens(colors))
        out["merged_coords"] = per_head_tokens(m_coords)
    return out


def replay_model(model, scene, backbone_kwargs: Dict[str, Any],
                 patch_size: int,
                 additional_info: Optional[Dict[str, Any]] = None,
                 blocks: Optional[List[str]] = None,
                 seed: int = 0) -> Dict[str, Dict[str, Any]]:
    """Replay every attention block (or those whose path contains one of
    ``blocks``) per head; each result also holds the block's ``coord``."""
    recs = collect_attention_blocks(model, scene)
    rng = np.random.default_rng(seed)
    out = {}
    for path, rec in recs.items():
        if blocks is not None and not any(b in path for b in blocks):
            continue
        heads = head_count_for(path, backbone_kwargs)
        res = replay_block(rec, heads, patch_size, additional_info, rng)
        res["coord"] = rec["attn_coord"].cpu().numpy()
        out[path] = res
    return out
