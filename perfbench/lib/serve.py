"""Serving cells: one client in a closed loop. A request is the program's
eval step (training/train_step.py:make_eval_step) on one pool scene, from
its issue until its rendered views, alpha and per-view PSNR and SSIM are
in host memory; the next request is issued when the previous one's
outputs are there.

With input downsampling the refine is compared in two stages, since the
backbone's grid is a floor of the reduced set's coordinates: the cluster
means, summed by atomic adds on the card, differ from run to run in the
last bit, and where one such bit crosses a grid cell's edge the patches
change and no tolerance can compare the refines. So the reduced set that
the program's own call made is compared with the reference's first, then
the reference runs its backbone, heads and map back on the program's
reduced set."""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from perfbench.lib import compare, program, weights
from perfbench.lib.base import Runner
from perfbench.reference import steps as reference


class Serve(Runner):
    def setup(self) -> None:
        self.model = program.build_model(self.cfg["model"], self.device)
        weights.load(self.model, self.model_state(self.model))
        self.make_pool()
        self.step = program.make_eval_step(self.model, self.rcfg)
        self.model.register_forward_hook(self._keep_refined)
        self.last_reduced = None
        self.staged = bool(self.cfg["model"]["additional_info"].get(
            "downsample"))
        self.undo_recording = (program.record_downsampling(
            self._keep_reduced) if self.staged else None)
        if self.traced:
            self.install_tracing()
        if self.plant is not None:
            self.plant(self)
        for i in range(self.tr["warmup"]):
            self.request(i)
        if self.traced:
            self.start_trace()

    def _keep_refined(self, module, args, out) -> None:
        self.last_refined = out

    def _keep_reduced(self, out) -> None:
        self.last_reduced = out

    def request(self, i: int):
        pi = int(self.order[i % len(self.order)])
        if self.traced:
            self.spans.begin("request")
        t = time.perf_counter()
        rgb, alpha, ps, ss, dropped = self.step(self.batches[pi])
        if self.traced:
            self.spans.begin("host_copy")
        host = {"rgb": rgb.cpu(), "alpha": alpha.cpu(), "psnr": ps.cpu(),
                "ssim": ss.cpu(), "dropped": int(dropped.cpu())}
        latency = time.perf_counter() - t
        if self.traced:
            self.spans.end("host_copy")
            self.spans.end("request")
        return pi, host, latency

    def window(self, seconds: float) -> None:
        """Requests until ``seconds`` have passed; a reservoir drawn from
        the seed keeps ``checked_requests`` of them for the comparison."""
        k = self.tr["checked_requests"]
        rng = random.Random(self.seed)
        self.kept: List = [None] * k
        self.latencies, self.failed, self.dropped = [], 0, 0
        self.traced_done = 0
        traced_n = self.tr["traced_requests"] if self.traced else 0
        i = 0
        if traced_n:
            self.trace_ns = [time.time_ns()]
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            slot = i if i < k else rng.randrange(i + 1)
            pi, host, latency = self.request(i)
            self.latencies.append(latency)
            # a non-finite pixel makes its view's scores non-finite; the
            # kept requests' pixels are compared after the window
            ok = bool(torch.isfinite(host["psnr"]).all()
                      and torch.isfinite(host["ssim"]).all())
            self.failed += int(not ok)
            self.dropped += host["dropped"]
            if slot < k:
                self.kept[slot] = (i, pi, host, self.last_refined,
                                   self.last_reduced)
            i += 1
            if i == traced_n:
                self.traced_done = i
                self.close_trace()
        self.window_s = time.perf_counter() - w0
        if self.prof is not None:
            self.traced_done = i
            self.close_trace()
        self.kept = [x for x in self.kept if x is not None]

    def measured(self) -> Dict:
        out = {"kind": "serve", "done": len(self.latencies),
               "window_s": self.window_s, "latencies_s": self.latencies,
               "failed": self.failed}
        if self.traced:
            out.update(self.traced_measures(), traced_done=self.traced_done)
        return out

    # -- after the window -----------------------------------------------------
    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.kept = [(i, pi, host, {k: getattr(r, k) for k in
                                    compare.SCENE_ATTRS}, reduced)
                     for i, pi, host, r, reduced in self.kept]
        del self.model, self.step, self.batches, self.last_refined
        self.last_reduced = None
        if self.undo_recording is not None:
            self.undo_recording()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, lower=None) -> Dict[str, float]:
        """The compared numbers over the kept requests, stage by stage: the
        program's refined scene against the reference's refine of the same
        input, and the program's images and scores against the reference's
        render and scoring of the program's refined scene. With input
        downsampling, the program's reduced set against the reference's
        (``assign_mismatch``, ``reduced_gap``), and the refine against the
        reference's on the program's reduced set. With ``lower`` the
        reference in the lower precision (TF32 products, bfloat16 entries)
        takes the program's place: the control."""
        ref = reference.build_model(self.cfg["model"], self.device)
        weights.load(ref, self.model_state(ref))
        worst: Dict[str, float] = {}
        for i, pi, host, refined, reduced in self.kept:
            p = self.pool[pi]
            found = {}
            if lower:
                reduced = (reference.reduce(ref, p["noisy"], lower)
                           if self.staged else None)
                refined = reference.refine(ref, p["noisy"], lower, reduced)
                host = reference.render_and_score(
                    refined, p["noisy"]["mask"], p["clean"], self.cams,
                    self.bgs[pi], lower)
            if self.staged:
                found = compare.reduced_numbers(
                    reduced, reference.reduce(ref, p["noisy"]))
            want_refined = reference.refine(ref, p["noisy"], reduced=reduced)
            want = reference.render_and_score(
                refined, p["noisy"]["mask"], p["clean"], self.cams,
                self.bgs[pi])
            found.update(compare.image_numbers(host, want))
            found["refine_gap"] = compare.refine_gap(refined, want_refined,
                                                     p["noisy"])
            for name, v in found.items():
                worst[name] = max(worst.get(name, 0.0), v)
            del want_refined, want, found, reduced
        worst["dropped"] = float(self.dropped)
        return worst
