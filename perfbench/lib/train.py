"""Training cells: the program's train step (training/train_step.py:
make_train_step) with the recipe's optimizer, one pool scene a step. Set-up
builds the step once and drives it through the checked steps (the first
``checked_steps``, which are also the warm-up); the window goes on with
that same object. Each step ends synchronised."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.lib import compare, program, spans, weights
from perfbench.lib.base import Runner
from perfbench.reference import steps as reference
from perfbench.reference.lpips import LPIPS as ReferenceLPIPS


class Train(Runner):
    def step_seed(self, i: int) -> int:
        return int(np.random.SeedSequence([self.seed, 5, i])
                   .generate_state(1)[0])

    def lpips_state(self, module):
        return weights.lpips_state(weights.shapes(module), self.seed,
                                   self.device)

    def setup(self) -> None:
        r, dev = self.tr["recipe"], self.device
        self.model = program.build_model(
            self.cfg["model"], dev, torch.bfloat16 if r["bf16"] else None)
        weights.load(self.model, self.model_state(self.model))
        with torch.device(dev):
            self.lpips = program.LPIPS()
        weights.load(self.lpips, self.lpips_state(self.lpips))
        self.lpips.eval()
        self.opt = program.build_optimizer(
            self.model, dict(r["lr_dict"]), r["optimizer"], r["eps"],
            r["schedule"], r["total_steps"], r["warmup_steps"],
            r["grad_clip_norm"])
        self.make_pool()
        self.step = program.make_train_step(
            self.model, self.opt, self.rcfg,
            image_l1_loss_weight=r["image_l1_loss_weight"],
            lpips_loss_weight=r["lpips_loss_weight"], lpips=self.lpips)
        self.gen = torch.Generator(device=dev)
        if self.traced:
            self.install_tracing()
            self.opt.step = spans.wrap_function(self.opt.step, self.spans,
                                                "optimizer")
        if self.plant is not None:
            self.plant(self)
        self.losses: List[float] = []
        hook = self.model.register_forward_hook(self._keep_refined)
        for i in range(self.tr["checked_steps"]):
            self.losses.append(self.train_step(i))
            if i == 0:
                hook.remove()
                self.first_grads = {n: (m / (1 - 0.9)).cpu() for n, m in
                                    zip(self.opt.names, self.opt.mu)}
        self.params_after = {n: p.detach().to("cpu", copy=True)
                             for n, p in self.model.named_parameters()}
        if self.traced:
            self.start_trace()

    def _keep_refined(self, module, args, out) -> None:
        """The first checked step's refined scene, as its forward gave it."""
        self.first_refined = {k: getattr(out, k).detach().cpu()
                              for k in compare.SCENE_ATTRS}

    def train_step(self, i: int) -> float:
        pi = int(self.order[i % len(self.order)])
        if self.traced:
            self.spans.begin("step")
        self.gen.manual_seed(self.step_seed(i))
        metrics = self.step(self.batches[pi], self.gen)
        loss = float(metrics["total_loss"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.traced:
            self.spans.end("step")
        return loss

    def window(self, seconds: float) -> None:
        traced_n = self.tr["traced_steps"] if self.traced else 0
        i0 = i = self.tr["checked_steps"]
        self.failed = 0
        self.step_s: List[float] = []
        if traced_n:
            self.trace_ns = [time.time_ns()]
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            t = time.perf_counter()
            self.failed += int(not np.isfinite(self.train_step(i)))
            self.step_s.append(time.perf_counter() - t)
            i += 1
            if i - i0 == traced_n:
                self.traced_done = traced_n
                self.close_trace()
        self.window_s = time.perf_counter() - w0
        if self.prof is not None:
            self.traced_done = i - i0
            self.close_trace()
        self.done = i - i0

    def measured(self) -> Dict:
        out = {"kind": "train", "done": self.done, "window_s": self.window_s,
               "failed": self.failed, "step_s": self.step_s}
        if self.traced:
            out.update(self.traced_measures(), traced_done=self.traced_done)
        return out

    # -- after the window -----------------------------------------------------
    def free(self) -> None:
        del self.model, self.step, self.opt, self.lpips, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, lower=None) -> Dict:
        """The reference through the checked steps, from the seeded weights,
        on the same scenes, backgrounds and draws; ``lower`` runs it in the
        program's place in the precision below the blocks' (the control):
        bfloat16 blocks (``bf16``: the control of a float32 recipe), their
        products' operands rounded by ``lower`` otherwise."""
        r, dev = self.tr["recipe"], self.device
        ref = reference.build_model(self.cfg["model"], dev,
                                    torch.bfloat16 if lower else None)
        weights.load(ref, self.model_state(ref))
        reference.set_block_rounding(ref, None if lower == "bf16" else lower)
        with torch.device(dev):
            lp = ReferenceLPIPS()
        weights.load(lp, self.lpips_state(lp))
        lp.eval()
        batches = []
        for i in range(self.tr["checked_steps"]):
            pi = int(self.order[i % len(self.order)])
            gen = torch.Generator(device=dev).manual_seed(self.step_seed(i))
            batches.append({"noisy": self.pool[pi]["noisy"],
                            "clean": self.pool[pi]["clean"],
                            "cams": self.cams, "background": self.bgs[pi],
                            "generator": gen})
        return reference.train_steps(ref, lp, batches, r)

    def numbers(self, lower=None) -> Dict[str, float]:
        want = self.reference_steps()
        if lower:
            got = self.reference_steps(lower)
        else:
            got = {"losses": self.losses, "first_grads": self.first_grads,
                   "params": self.params_after,
                   "first_refined": self.first_refined}
        init = weights.model_state(
            {k: v.shape for k, v in want["params"].items()}, self.seed,
            self.device, self.cfg["weights"]["head_final_scale"],
            self.cfg["model"]["output_head_nlayer"])
        pi = int(self.order[0])
        return compare.train_numbers(got, want, init, self.pool[pi]["noisy"])
