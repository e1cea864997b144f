"""The optimizer (port of splatformer_tpu/training/optim.py), written out to
compute what the JAX package's optax chain computes:

    MultiSteps(k)( clip_by_global_norm(max_norm)
                   -> per-group Adam(schedule, eps) or SGD(schedule)
                   -> finetune filter )

  * groups: ``backbone``, and one per output head ``head_<feature>`` whose
    learning rate is ``lr_dict[<feature>]`` (else ``lr_dict['base']``);
  * Adam as optax's scale_by_adam (b1 0.9, b2 0.999, eps added OUTSIDE the
    square root, bias-corrected moments), then scaled by -lr(count) where
    the first update uses the schedule at count 0;
  * the global-norm clip is optax's ``t if ||g|| < max_norm else
    (t / ||g||) * max_norm`` (not ``clip_grad_norm_``, which divides by
    ``||g|| + 1e-6``);
  * ``accumulate_steps`` k > 1: the running mean of k gradients goes through
    the chain on every k-th step; the parameters are untouched in between;
  * ``finetune_filter``: after Adam, updates of parameters whose
    '/'-joined name (``backbone/enc0_block0/attn/qkv/weight``) contains
    none of the filter's strings are zeroed (their moments still update).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from splatformer_tpu_torch import tracing

B1, B2 = 0.9, 0.999


def build_schedule(base_lr: float, schedule: str, total_steps: int,
                   warmup_steps: int = 0) -> Callable[[int], float]:
    """count -> learning rate: 'constant', 'linear' (to 0 at total_steps)
    or 'cosine' (to 0 at total_steps), optionally after a linear warmup
    from 0 over ``warmup_steps`` (optax.join_schedules: the main schedule
    restarts its count at the boundary)."""
    if schedule == "constant":
        def main(count):
            return base_lr
    elif schedule == "linear":
        def main(count):
            c = min(max(count, 0), total_steps)
            return base_lr * (1.0 - c / total_steps)
    elif schedule == "cosine":
        def main(count):
            c = min(count, total_steps)
            return base_lr * (0.5 * (1.0 + math.cos(math.pi * c
                                                     / total_steps)))
    else:
        raise NotImplementedError(schedule)
    if warmup_steps <= 0:
        return main

    def joined(count):
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            return -base_lr * (1.0 - c / warmup_steps) + base_lr
        return main(count - warmup_steps)
    return joined


def adam_update(grads: List[torch.Tensor], mu: List[torch.Tensor],
                nu: List[torch.Tensor], counts: Sequence[int], eps: float):
    """optax's scale_by_adam on lists of tensors (``torch._foreach_*``):
    returns the new first and second moments and the bias-corrected
    updates; ``counts`` are each tensor's update counts after this step,
    the bias corrections float32 as optax computes them."""
    bc1 = [float(np.float32(1) - np.float32(B1) ** np.float32(c))
           for c in counts]
    bc2 = [float(np.float32(1) - np.float32(B2) ** np.float32(c))
           for c in counts]
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1),
                            torch._foreach_mul(mu, B1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2),
        torch._foreach_mul(nu, B2))
    denom = torch._foreach_add(
        torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    return mu, nu, torch._foreach_div(torch._foreach_div(mu, bc1), denom)


def param_label(name: str) -> str:
    """'backbone' or the feature of an output head ``head_<feature>``."""
    top = name.split(".", 1)[0]
    return top[len("head_"):] if top.startswith("head_") else "backbone"


class ChainOptimizer:
    """Call ``step()`` after ``backward()``; reads and clears ``p.grad``.
    ``count`` is the number of updates applied (optax's inner count)."""

    def __init__(self, named_params, lr_dict: Dict[str, float],
                 optimizer_type: str, eps: float, schedule: str,
                 total_steps: int, warmup_steps: int,
                 grad_clip_norm: float, accumulate_steps: int,
                 finetune_filter: Optional[Sequence[str]]):
        if optimizer_type.lower() not in ("adam", "sgd"):
            raise NotImplementedError(optimizer_type)
        self.adam = optimizer_type.lower() == "adam"
        self.names: List[str] = []
        self.params: List[nn.Parameter] = []
        for name, p in named_params:
            if p.requires_grad:
                self.names.append(name)
                self.params.append(p)
        self.eps = eps
        self.clip = grad_clip_norm if grad_clip_norm and grad_clip_norm > 0 \
            else None
        self.k = max(1, int(accumulate_steps))
        self.schedules = {}
        self.labels = [param_label(n) for n in self.names]
        for label in set(self.labels):
            lr = lr_dict.get(label, lr_dict.get("base", 0.0))
            self.schedules[label] = build_schedule(lr, schedule, total_steps,
                                                   warmup_steps)
        self.keep = [True] * len(self.params)
        if finetune_filter:
            self.keep = [any(s in n.replace(".", "/") for s in finetune_filter)
                         for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)
        self.mini_step = 0
        self.count = 0

    def state_dict(self) -> Dict[str, object]:
        """The optimizer's state (moments, accumulator, counters), keyed by
        parameter name; the tensors are the live ones, not copies."""
        return {"names": list(self.names), "mu": self.mu, "nu": self.nu,
                "acc": self.acc, "mini_step": self.mini_step,
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a ``state_dict()`` into this optimizer's tensors (on their
        devices); the parameter names must match."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state is for other parameters")
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc or [], state["acc"] or [])):
            if len(mine) != len(theirs):
                raise ValueError("optimizer state has another accumulation")
            for dst, src in zip(mine, theirs):
                dst.copy_(src)
        self.mini_step = int(state["mini_step"])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Apply one optimizer step (on the first k - 1 steps of each
        accumulation only the running mean moves). Multi-tensor
        (``torch._foreach_*``) ops, each the elementwise operation that
        optax applies leaf by leaf."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.acc is not None:
            diff = torch._foreach_sub(grads, self.acc)
            self.acc = torch._foreach_add(
                self.acc, torch._foreach_div(diff, self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % self.k
            if self.mini_step != 0:
                return
            grads = self.acc
            self.acc = [torch.zeros_like(p) for p in self.params]
        if self.clip is not None:
            with tracing.span("optimizer.clip"):
                norm = torch.linalg.vector_norm(torch.stack(
                    torch._foreach_norm(grads)))
                below = norm < self.clip
                one = torch.ones_like(norm)
                # t if ||g|| < max_norm else (t / ||g||) * max_norm
                grads = torch._foreach_mul(
                    torch._foreach_div(grads, torch.where(below, one, norm)),
                    torch.where(below, one, torch.full_like(norm, self.clip)))
        with tracing.span("optimizer.adam"):
            self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> None:
        """Adam (or SGD) on the clipped gradients, each group's parameters
        moved by its learning rate."""
        count = self.count + 1
        if self.adam:
            self.mu, self.nu, updates = adam_update(
                grads, self.mu, self.nu, [count] * len(grads), self.eps)
        else:
            updates = grads
        for label, sched in self.schedules.items():
            idx = [i for i, lb in enumerate(self.labels)
                   if lb == label and self.keep[i]]
            if idx:
                torch._foreach_add_(
                    [self.params[i] for i in idx],
                    torch._foreach_mul([updates[i] for i in idx],
                                    -sched(self.count)))
        self.count = count


def build_optimizer(
    model: nn.Module,
    lr_dict: Dict[str, float],
    optimizer_type: str = "adam",
    eps: float = 1e-15,
    schedule: str = "constant",
    total_steps: int = 200_000,
    warmup_steps: int = 0,
    grad_clip_norm: float = 2.0,
    accumulate_steps: int = 1,
    finetune_filter: Optional[Sequence[str]] = None,
) -> ChainOptimizer:
    """The training optimizer over a FeaturePredictor's parameters.
    ``lr_dict`` has the reference config's shape: {'base': ..., 'backbone':
    ..., '<feature>': ...}."""
    return ChainOptimizer(model.named_parameters(), lr_dict, optimizer_type,
                          eps, schedule, total_steps, warmup_steps,
                          grad_clip_norm, accumulate_steps, finetune_filter)


class GaussianOptimizer:
    """Per-attribute optimizer over raw Gaussian parameters (port of
    build_gs_optimizer's and fit_gs.build_fit_optimizer's
    ``optax.multi_transform``): one Adam (b1 0.9, b2 0.999, eps outside the
    square root, bias-corrected) or SGD a key of the parameter dict, each
    with its own update count. A learning rate is a float, or a schedule
    count -> lr read at the count before the update, as optax's
    scale_by_schedule does. ``step`` updates the parameters in place."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 lrs: Dict[str, object], optimizer_type: str = "adam",
                 eps: float = 1e-15):
        if optimizer_type.lower() not in ("adam", "sgd"):
            raise NotImplementedError(optimizer_type)
        self.adam = optimizer_type.lower() == "adam"
        self.lrs = dict(lrs)
        self.eps = eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = dict.fromkeys(params, 0)

    def lr(self, key: str) -> float:
        lr = self.lrs[key]
        return float(lr(self.count[key])) if callable(lr) else lr

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        keys = list(params)
        counts = [self.count[k] + 1 for k in keys]
        updates = [grads[k] for k in keys]
        if self.adam:
            mu, nu, updates = adam_update(updates,
                                          [self.mu[k] for k in keys],
                                          [self.nu[k] for k in keys],
                                          counts, self.eps)
            self.mu.update(zip(keys, mu))
            self.nu.update(zip(keys, nu))
        torch._foreach_add_([params[k] for k in keys], torch._foreach_mul(
            updates, [-self.lr(k) for k in keys]))
        self.count.update(zip(keys, counts))

    @torch.no_grad()
    def reset_rows(self, rows: torch.Tensor) -> None:
        """Zero both moments of the given slots of every attribute (new
        Gaussians start with fresh moments); the counts are kept."""
        for k in self.mu:
            self.mu[k][rows] = 0
            self.nu[k][rows] = 0


def build_gs_optimizer(gs_params: Dict[str, torch.Tensor],
                       lr_dict: Dict[str, float],
                       optimizer_type: str = "adam",
                       eps: float = 1e-15) -> GaussianOptimizer:
    """Per-attribute optimizer over raw Gaussian parameters (the reference's
    build_3DGSoptimizer, utils/optimizers.py:18-37): a key's learning rate
    is ``lr_dict[key]``, else ``lr_dict['base']``, else 1e-3."""
    lrs = {k: lr_dict.get(k, lr_dict.get("base", 1e-3)) for k in gs_params}
    return GaussianOptimizer(gs_params, lrs, optimizer_type, eps)
