"""Token merging inside serialized patch attention (a frozen copy of
splatformer_tpu_torch/ops/merging.py), the fork's efficiency study.

Given per-patch q/k/v of shape (B, H, K, c) and a merge ratio r,
``process_merging`` returns reduced (B, H, K', c) tensors, a ``size``
tensor (B, H, K', 1) counting how many original tokens each reduced token
stands for (proportional attention adds ``log(size)`` to the logits), and
an ``unmerge`` closure that scatters reduced features back to (B, H, K, c).
The modes: ToMe bipartite soft matching (``tome``, ``progressive``), ToFu
norm-preserving fusion, PiToMe energy-ordered matching with protected
tokens, importance pruning, block pooling (``patch``, ``wpatch``,
``random_patch``, ``important_patch``) and ALGM's threshold-gated adjacent
merging, which keeps K' = K and gives merged-away slots size 0.

Everything here is plain PyTorch, as the JAX package leaves it to XLA
outside any kernel. What must match it exactly:

  * every sort is stable (``jnp.argsort`` is; ``torch.argsort`` only with
    ``stable=True``): a padded patch repeats its last point, so its tokens
    and their scores tie;
  * ``argmax`` takes the first maximum (``torch.argmax`` does, on both
    devices);
  * scores and routing sums are computed in float32 and cast back to the
    input's dtype (the JAX einsums' ``preferred_element_type``); ``route``
    and ``size`` are in the metric's dtype;
  * the merge count is capped at K // 2 (``merge_count``), so every rate
    from 0.5 up merges the same tokens in the bipartite and block modes.

Random draws (``random_patch`` in training) come from ``uniform``, a
callable ``shape -> uniform [0, 1) tensor`` that the caller builds from its
generator or from injected draws; ``None`` takes the blocks in order, as
the JAX package does without an rng.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

MERGE_MODES = ("tome", "tofu", "pitome", "prune", "patch", "wpatch", "algm",
               "progressive", "random_patch", "important_patch")

Uniform = Callable[[Sequence[int]], torch.Tensor]
MergeFn = Callable[[torch.Tensor], torch.Tensor]


def needs_rng(mode: str, info: Dict[str, Any]) -> bool:
    return mode == "random_patch" and not info.get("no_rand", False)


def merge_count(k: int, r: float) -> int:
    """Tokens a patch of ``k`` merges away at rate ``r``: int(k r), capped
    at k // 2."""
    return max(0, min(k // 2, int(k * r)))


def _normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., K, c) rows ``idx`` (..., M) along -2 (take_along_axis)."""
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


def _put(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
         ) -> torch.Tensor:
    """x with rows ``idx`` (..., M) along -2 set to ``vals`` (..., M, c);
    the indices are distinct, so the result is deterministic."""
    return x.scatter(-2, idx[..., None].expand_as(vals), vals)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(..., K/2, c) even and odd rows -> (..., K, c)."""
    return torch.stack([even, odd], dim=-2).flatten(-3, -2)


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, dim=-1, stable=True)


# ---------------------------------------------------------------------------
# bipartite soft matching (ToMe) and relatives
# ---------------------------------------------------------------------------

def _bipartite(metric: torch.Tensor, r_count: int, fuse: str = "mean",
               src_protect: Optional[torch.Tensor] = None):
    """metric (B, H, K, c) -> (merge, unmerge, size). src = even positions,
    dst = odd ones; the r_count src tokens most similar to their best dst
    merge into it, as the mean (``fuse="mean"``) or, ToFu's ``"norm"``,
    rescaled to the larger of the dst's norm and the merged srcs' summed
    norms. Output rows: [kept src (K/2 - r), dst (K/2)].
    ``src_protect`` (K/2,) bool ranks those src slots last (PiToMe)."""
    b, h, k, _ = metric.shape
    half = k // 2
    r_count = min(r_count, half)
    dt = metric.dtype
    kn = _normalize(metric)
    src, dst = kn[..., 0::2, :], kn[..., 1::2, :]
    scores = torch.matmul(src.float(), dst.float().transpose(-1, -2))
    best, best_dst = scores.max(dim=-1).values, scores.argmax(dim=-1)
    if src_protect is not None:
        best = torch.where(src_protect, -torch.inf, best)
    order = _argsort(-best)                          # merged first
    merged_rank, kept_rank = order[..., :r_count], order[..., r_count:]

    is_merged = torch.zeros((b, h, half), dtype=torch.bool,
                            device=metric.device)
    is_merged = is_merged.scatter(-1, merged_rank, True)
    # one-hot routing of merged src rows into dst rows
    route = torch.nn.functional.one_hot(best_dst, half).to(dt)
    route = route * is_merged[..., None].to(dt)      # (B, H, src, dst)
    route_t = route.transpose(-1, -2)
    size_dst = 1.0 + route.sum(dim=-2)               # (B, H, half)
    size = torch.cat([torch.ones((b, h, half - r_count), dtype=dt,
                                 device=metric.device), size_dst],
                     dim=-1)[..., None]

    def merge(x: torch.Tensor) -> torch.Tensor:
        xs, xd = x[..., 0::2, :], x[..., 1::2, :]
        add = torch.matmul(route_t.float(), xs.float()).to(x.dtype)
        xd_m = (xd + add) / size_dst[..., None]
        if fuse == "norm":  # ToFu: the mean's direction, the larger norm
            merged = torch.matmul(route_t, _norm(xs)[..., None])[..., 0]
            target = torch.maximum(_norm(xd), merged)
            xd_m = xd_m * (target / (_norm(xd_m) + 1e-6))[..., None]
        return torch.cat([_take(xs, kept_rank), xd_m], dim=-2)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        kept_y, dst_y = y[..., :half - r_count, :], y[..., half - r_count:, :]
        # merged src slots copy their dst row, kept ones take their own
        src_y = torch.matmul(route.float(), dst_y.float()).to(y.dtype)
        return _interleave(_put(src_y, kept_rank, kept_y), dst_y)

    return merge, unmerge, size


# ---------------------------------------------------------------------------
# block/patch pooling variants
# ---------------------------------------------------------------------------

def _patch_blocks(metric: torch.Tensor, r_count: int, stride: int,
                  select: str, uniform: Optional[Uniform], weighted: bool):
    """Pool whole contiguous blocks of g = stride tokens (the largest g <=
    stride dividing K) into one token each: n_merge blocks chosen by
    ``select`` ('first' | 'important' | 'random'), K' = K - n_merge (g - 1).
    Output rows: [kept blocks' tokens, pooled tokens]."""
    b, h, k, c = metric.shape
    dt = metric.dtype
    g = max(2, min(stride, k))
    while k % g != 0:
        g -= 1
    nb = k // g
    n_merge = min(nb, r_count // (g - 1)) if g > 1 else 0

    blocks = metric.reshape(b, h, nb, g, c)
    iota = torch.arange(nb, device=metric.device).expand(b, h, nb)
    if select == "important":
        # lowest internal variance (most redundant) merged first; the
        # variance as jnp.var forms it: squared deviations summed, over g
        dev = blocks - blocks.mean(dim=-2, keepdim=True)
        order = _argsort((dev * dev).sum(dim=-2).div(g).sum(dim=-1))
    elif select == "random" and uniform is not None:
        order = _argsort(uniform((b, h, nb)).to(metric.device))
    else:  # 'first', or 'random' without draws
        order = iota
    merge_blocks = order[..., :n_merge]
    keep_blocks = torch.sort(order[..., n_merge:], dim=-1).values

    if weighted:
        centroid = blocks.mean(dim=-2, keepdim=True)
        w = (_normalize(blocks) * _normalize(centroid)).sum(-1)
        w = torch.softmax(w, dim=-1)[..., None]      # (B, H, nb, g, 1)
    else:
        w = torch.full((b, h, nb, g, 1), 1.0 / g, dtype=dt,
                       device=metric.device)
    size = torch.cat([
        torch.ones((b, h, (nb - n_merge) * g), dtype=dt,
                   device=metric.device),
        torch.full((b, h, n_merge), float(g), dtype=dt,
                   device=metric.device)], dim=-1)[..., None]
    n_kept = (nb - n_merge) * g
    keep_rows = (keep_blocks[..., None] * g + torch.arange(
        g, device=metric.device)).flatten(-2)        # (B, H, n_kept)

    def merge(x: torch.Tensor) -> torch.Tensor:
        pooled = (x.reshape(b, h, nb, g, x.shape[-1]) * w).sum(dim=-2)
        return torch.cat([_take(x, keep_rows), _take(pooled, merge_blocks)],
                         dim=-2)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        m = y[..., n_kept:, :]                       # (B, H, n_merge, c)
        merged_rows = (merge_blocks[..., None] * g + torch.arange(
            g, device=y.device)).flatten(-2)
        out = y.new_zeros((b, h, k, y.shape[-1]))
        out = _put(out, keep_rows, y[..., :n_kept, :])
        return _put(out, merged_rows, m.repeat_interleave(g, dim=-2))

    return merge, unmerge, size


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

def _prune(metric: torch.Tensor, r_count: int):
    """Keep the K - r most distinctive tokens (least similar to the mean
    direction); a pruned slot unmerges as its most similar kept token."""
    b, h, k, _ = metric.shape
    kp = k - min(r_count, k - 1)
    kn = _normalize(metric)
    centroid = _normalize(kn.mean(dim=-2, keepdim=True))
    redundancy = torch.matmul(kn, centroid.transpose(-1, -2))[..., 0]
    keep = torch.sort(_argsort(redundancy)[..., :kp], dim=-1).values
    sim_all = torch.matmul(kn, _take(kn, keep).transpose(-1, -2))
    nearest_kept = sim_all.argmax(dim=-1)            # (B, H, K) into kept
    size = torch.ones((b, h, kp, 1), dtype=metric.dtype,
                      device=metric.device)

    def merge(x: torch.Tensor) -> torch.Tensor:
        return _take(x, keep)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return _take(y, nearest_kept)

    return merge, unmerge, size


# ---------------------------------------------------------------------------
# PiToMe: energy-ordered bipartite merging with protected tokens
# ---------------------------------------------------------------------------

def _pitome(metric: torch.Tensor, r_count: int, margin: float, alpha: float,
            protected_ratio: float = 0.0):
    k = metric.shape[-2]
    kn = _normalize(metric)
    sim = torch.matmul(kn, kn.transpose(-1, -2))
    f = torch.where(sim >= margin, sim,
                    alpha * (torch.exp(sim - margin) - 1.0))
    energy = f.mean(dim=-1)                          # (B, H, K)
    # high energy (redundant) first, so those become the src candidates
    order = _argsort(-energy)
    inv = _argsort(order)
    src_protect = None
    if protected_ratio > 0.0:
        # the lowest-energy ceil(p K) tokens take the last sorted slots: a
        # fixed slot mask, and a cap on the merge count
        n_p = int(np.ceil(protected_ratio * k))
        prot = np.arange(k) >= k - n_p
        src_protect = torch.as_tensor(prot[0::2], device=metric.device)
        r_count = min(r_count, k // 2 - int(prot[0::2].sum()))
    merge_b, unmerge_b, size = _bipartite(_take(metric, order), r_count,
                                          src_protect=src_protect)

    def merge(x: torch.Tensor) -> torch.Tensor:
        return merge_b(_take(x, order))

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return _take(unmerge_b(y), inv)

    return merge, unmerge, size


# ---------------------------------------------------------------------------
# ALGM-style threshold-gated adjacent merging
# ---------------------------------------------------------------------------

def _algm(metric: torch.Tensor, r_count: int, threshold: float):
    """Merge adjacent serialized pairs (2i, 2i + 1) whose cosine similarity
    reaches ``threshold``, at most ``r_count`` of them (the most similar;
    0 = no cap). K' = K: a merged pair's odd slot stays as a dead slot of
    size 0, which proportional attention (+log(size)) removes from every
    softmax; ``unmerge`` restores it from its pair head."""
    b, h, k, _ = metric.shape
    half = k // 2
    kn = _normalize(metric)
    sim = (kn[..., 0::2, :] * kn[..., 1::2, :]).sum(dim=-1)  # (B, H, half)
    qualifies = sim >= threshold
    if r_count > 0:
        rc = min(r_count, half)
        gated = torch.where(qualifies, sim, -torch.inf)
        rank = _argsort(_argsort(-gated))
        qualifies = qualifies & (rank < rc)
    mf = qualifies.to(metric.dtype)[..., None]      # (B, H, half, 1)
    size = _interleave(1.0 + mf, 1.0 - mf)
    merged = mf > 0

    def merge(x: torch.Tensor) -> torch.Tensor:
        xe, xo = x[..., 0::2, :], x[..., 1::2, :]
        ye = torch.where(merged, 0.5 * (xe + xo), xe)
        return _interleave(ye, torch.where(merged, torch.zeros_like(xo), xo))

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        ye, yo = y[..., 0::2, :], y[..., 1::2, :]
        return _interleave(ye, torch.where(merged, ye, yo))

    return merge, unmerge, size


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_merge(mode: str, metric: torch.Tensor, info: Dict[str, Any],
                uniform: Optional[Uniform] = None
                ) -> Tuple[MergeFn, MergeFn, torch.Tensor]:
    """(merge, unmerge, size) from a similarity metric (B, H, K, c), so one
    partition merges q, k, v (and anything else) consistently."""
    kk = metric.shape[-2]
    if kk % 2:
        raise ValueError(f"token merging needs an even patch, got {kk}")
    r_count = merge_count(kk, float(info.get("r", 0.0) or 0.0))
    if info.get("single_head_tome"):
        metric = metric.mean(dim=1, keepdim=True).expand_as(metric)

    if mode in ("tome", "progressive"):
        return _bipartite(metric, r_count, fuse="mean")
    if mode == "tofu":
        return _bipartite(metric, r_count, fuse="norm")
    if mode == "pitome":
        return _pitome(metric, r_count,
                       margin=float(info.get("margin", 0.9)),
                       alpha=float(info.get("alpha", 1.0)),
                       protected_ratio=float(info.get("protected_ratio",
                                                      0.0)))
    if mode == "prune":
        return _prune(metric, r_count)
    if mode in ("patch", "wpatch", "random_patch", "important_patch"):
        if mode == "wpatch":
            # low_r: the fewest tokens that must survive
            r_count = min(r_count, max(0, kk - int(info.get("low_r", 16))))
        select = {"patch": "first", "wpatch": "first",
                  "random_patch": "random",
                  "important_patch": "important"}[mode]
        return _patch_blocks(metric, r_count, int(info.get("stride", 10)),
                             select, uniform, weighted=(mode == "wpatch"))
    if mode == "algm":
        return _algm(metric, r_count,
                     threshold=float(info.get("threshold", 0.9)))
    raise NotImplementedError(mode)


def process_merging(mode: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, info: Dict[str, Any],
                    uniform: Optional[Uniform] = None):
    """-> (q', k', v', size, unmerge), the keys as the metric. ``size``
    feeds proportional attention; ``unmerge`` maps (B, H, K', c) back to
    (B, H, K, c)."""
    merge, unmerge, size = build_merge(mode, k, info, uniform)
    return merge(q), merge(k), merge(v), size, unmerge
