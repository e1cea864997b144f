"""The numbers that decide ``correct``: the program's outputs against the
reference's, each beside its limit (perfbench/limits/<cell>.json)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

SCENE_ATTRS = ("means", "scales", "quats", "opacities", "features_dc",
               "features_rest")


def _max(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def refine_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               inputs: Dict) -> float:
    """The largest gap of a refined attribute over the live rows, as a share
    of the largest move the reference's refine makes in that attribute."""
    mask = inputs["mask"]
    worst = 0.0
    for k in SCENE_ATTRS:
        g = got[k][mask].float()
        w = want[k][mask].float()
        moved = _max(w - inputs[k][mask].float())
        worst = max(worst, _max(g - w) / max(moved, 1e-30))
    return worst


def refine_rms_gap(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor], inputs: Dict) -> float:
    """The largest over the attributes of the root-mean-square gap of a
    refined attribute over the live rows, as a share of the root mean
    square of the reference's refine move in that attribute: steady from
    seed to seed where the largest single gap swings."""
    mask = inputs["mask"]
    worst = 0.0
    for k in SCENE_ATTRS:
        w = want[k][mask].double()
        gap = torch.linalg.vector_norm(got[k][mask].double() - w)
        moved = torch.linalg.vector_norm(w - inputs[k][mask].double())
        worst = max(worst, float(gap) / max(float(moved), 1e-30))
    return worst


def image_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """``image_gap``: the largest gap of a pixel's rgb or alpha;
    ``psnr_gap`` (dB) and ``ssim_gap``: the largest per-view gaps."""
    dev = want["rgb"].device
    return {"image_gap": max(_max(got["rgb"].to(dev) - want["rgb"]),
                             _max(got["alpha"].to(dev) - want["alpha"])),
            "psnr_gap": _max(got["psnr"].to(dev) - want["psnr"]),
            "ssim_gap": _max(got["ssim"].to(dev) - want["ssim"])}


def reduced_numbers(got, want) -> Dict[str, float]:
    """Input downsampling's reduced set, the program's ``got`` against the
    reference's ``want`` (coord, feat, mask, index: reference/downsample.py
    :reduce). ``assign_mismatch``: the points whose cluster differs (for
    random keep, the kept indices that differ) plus the reduced rows whose
    liveness differs; ``reduced_gap``: over the rows live in both, the
    largest gap of a coordinate, as a share of the reference's extent (its
    widest axis), or of a feature, as a share of that feature's range."""
    gc, gf, gm, gi = got
    wc, wf, wm, wi = want
    mismatch = int((gi != wi).sum()) + int((gm != wm).sum())
    live = gm & wm
    if not bool(live.any()):
        return {"assign_mismatch": float(mismatch), "reduced_gap": 0.0}
    w = wc[wm]
    extent = float((w.max(0).values - w.min(0).values).max())
    gap = _max(gc[live] - wc[live]) / max(extent, 1e-30)
    f = wf[wm]
    span = torch.clamp(f.max(0).values - f.min(0).values, min=1e-30)
    gap = max(gap, _max((gf[live] - wf[live]) / span))
    return {"assign_mismatch": float(mismatch), "reduced_gap": gap}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              leaves: List[str]) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's, as a
    share of the larger of the reference's norm of that leaf and of the
    median leaf."""
    gn, wn = _norms({k: got[k] for k in leaves}), _norms(
        {k: want[k] for k in leaves})
    med = sorted(wn.values())[len(wn) // 2]
    return [abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in leaves]


def moving_leaves(ref_grads: Dict[str, torch.Tensor],
                  share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: its
    norm at least ``share`` of the median leaf's (a key's bias under
    softmax, for one, moves under Adam by round-off alone)."""
    n = _norms(ref_grads)
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= share * med]


def train_numbers(got: Dict, want: Dict, init: Dict[str, torch.Tensor],
                  inputs: Dict) -> Dict[str, float]:
    """``refine1_rms_gap``: ``refine_rms_gap`` of the first checked step's
    refined scene (train mode, the same draws); ``loss_gap``: the largest
    relative gap of the checked steps' losses, ``loss1_gap`` the first
    step's; ``grad_gap``: the first step's gradient as the optimizer took
    it, ``update_gap``: the parameters' change over the checked steps, both
    by the worst leaf of ``leaf_gaps`` over the moving leaves."""
    gaps = [abs(g - w) / max(abs(w), 1e-30)
            for g, w in zip(got["losses"], want["losses"])]
    leaves = moving_leaves(want["first_grads"])
    dev = next(iter(want["params"].values())).device
    grad = leaf_gaps({k: got["first_grads"][k].to(dev) for k in leaves},
                     want["first_grads"], leaves)
    update = leaf_gaps({k: got["params"][k].to(dev) - init[k]
                        for k in leaves},
                       {k: want["params"][k] - init[k] for k in leaves},
                       leaves)
    refined = {k: v.to(dev) for k, v in got["first_refined"].items()}
    return {"refine1_rms_gap": refine_rms_gap(
                refined, want["first_refined"], inputs),
            "loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": max(grad), "update_gap": max(update),
            "moving_leaves": float(len(leaves))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} for every limited number; a number with no
    limit, or a non-finite one, fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        out[name] = {"value": v, "limit": limit}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
