"""Checkpoint save/restore (port of splatformer_tpu/training/checkpoints.py,
which uses orbax): ``torch.save`` of the whole training state, the
parameters and BatchNorm buffers (the model's state_dict), the optimizer's
moments, accumulator and counters, the step and the generator's state.

Layout: ``<ckpt_dir>/<step>/state.pt``, one directory per step, the three
newest kept (orbax's ``max_to_keep=3``). A save writes a temporary
directory and renames it into place, so an interrupted save leaves no half
checkpoint.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from splatformer_tpu_torch.models.feature_predictor import FeaturePredictor
from splatformer_tpu_torch.training.optim import ChainOptimizer

MAX_TO_KEEP = 3
STATE_FILE = "state.pt"


@dataclass
class TrainState:
    """What a train step changes: the model (parameters and BatchNorm
    statistics), the optimizer, the generator that drives DropPath and the
    order shuffle, and the micro-step count."""

    model: FeaturePredictor
    optimizer: ChainOptimizer
    generator: torch.Generator
    step: int = 0


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    max_to_keep: int = MAX_TO_KEEP) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(int(step)))
    tmp = os.path.join(ckpt_dir, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "generator": state.generator.get_state(),
                "step": int(state.step)}, os.path.join(tmp, STATE_FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def _load(ckpt_dir: str, step: Optional[int]) -> Optional[dict]:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Load the checkpoint at ``step`` (default the newest) into ``state``'s
    model, optimizer and generator, in place; returns ``state`` with its
    step set, or unchanged when the directory holds no checkpoint."""
    raw = _load(ckpt_dir, step)
    if raw is None:
        return state
    state.model.load_state_dict(raw["model"])
    state.optimizer.load_state_dict(raw["optimizer"])
    state.generator.set_state(raw["generator"])
    state.step = int(raw["step"])
    return state


def load_partial_params(ckpt_dir: str, params: Dict[str, torch.Tensor],
                        scope: str = "backbone", step: Optional[int] = None
                        ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Shape-tolerant partial load of the ``scope`` subtree of a state_dict
    from a checkpoint (the reference's pretrained-backbone path,
    models/pointtransformer_v3.py:164-178): entries missing from the
    checkpoint or of another shape keep their current value.

    Returns (merged state_dict, report) with report = {loaded, missing,
    mismatched}, lists of '/'-joined names."""
    report = {"loaded": [], "missing": [], "mismatched": []}
    raw = _load(ckpt_dir, step)
    if raw is None:
        return params, report
    src = raw["model"]
    merged = {}
    for k, v in params.items():
        path = k.replace(".", "/")
        if scope and k.split(".", 1)[0] != scope:
            merged[k] = v
        elif k not in src:
            report["missing"].append(path)
            merged[k] = v
        elif tuple(src[k].shape) != tuple(v.shape):
            report["mismatched"].append(path)
            merged[k] = v
        else:
            report["loaded"].append(path)
            merged[k] = src[k].to(dtype=v.dtype, device=v.device)
    return merged, report
