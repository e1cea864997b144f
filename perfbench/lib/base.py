"""What the serving and the training runners share: the seeded weights,
the pool, the spans and counters of traced runs, and the trace's end.

A traced run also turns the program's own tracer on before its warm-up,
clears it where the traced part starts and takes its snapshot where that
part ends (then turns it off); untraced runs never turn it on."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.lib import program, program_trace, scenes, spans, trace, weights


class Runner:
    def __init__(self, cell: Dict, seed: int, device, traced: bool):
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.seed, self.device, self.traced = seed, torch.device(device), traced
        self.spans = spans.Spans(device) if traced else None
        self.prof = None
        self.counts: List = []
        # a fault planted before the warm-up (lib/faults.py; tests and
        # control.py only), and what undoes it
        self.plant = None
        self.restore = None

    def model_state(self, module):
        """The seeded weights for a FeaturePredictor, the program's or the
        reference's."""
        return weights.model_state(
            weights.shapes(module), self.seed, self.device,
            self.cfg["weights"]["head_final_scale"],
            self.cfg["model"]["output_head_nlayer"])

    def make_pool(self) -> None:
        """The pool of scenes, the cameras, the backgrounds, the raster
        budgets, the ground truth and the request order."""
        cfg, tr, dev = self.cfg, self.tr, self.device
        self.pool = scenes.make_pool(self.seed, cfg["scene"], tr["pool"],
                                     tr["mean_noise"], dev)
        self.cams = scenes.orbit_cameras(tr["views"], tr["height"],
                                         tr["width"], tr["radius"],
                                         tr["elevation_deg"], dev)
        self.bgs = scenes.backgrounds(self.seed, tr["background"], tr["pool"],
                                      dev)
        self.rcfg = program.calibrate(
            [(p[k], self.cams) for p in self.pool for k in ("noisy", "clean")],
            tr["raster"])
        self.batches = [program.SceneBatch(
            scene=program.scene(p["noisy"]), cameras=program.camera(self.cams),
            images=program.render(p["clean"], self.cams, bg, self.rcfg),
            background=bg) for p, bg in zip(self.pool, self.bgs)]
        self.order = np.random.default_rng([self.seed, 4]).permutation(
            tr["pool"])

    def install_tracing(self) -> None:
        """Before the warm-up of a traced run: the harness's spans and
        counters, and the program's tracer on."""
        self.install_spans()
        program.tracing.enable(self.device)

    def install_spans(self) -> None:
        """Spans around the refine (hooks on the FeaturePredictor) and the
        render (the render_images_stats that the step looks up), and
        counters of each stage's live points and kernel-map pairs and of
        the scene's live points, at which the heads run."""
        spans.wrap_module(self.model, self.spans, "refine")
        self.model.register_forward_hook(
            lambda m, a, o: self.counts.append(("live", None,
                                                o.valid_mask().sum())))
        mod = program.train_step_module
        mod.render_images_stats = spans.wrap_function(
            mod.render_images_stats, self.spans, "render")
        bb = self.model.backbone
        bb.register_forward_pre_hook(
            lambda m, a: self.counts.append(("points", 0, a[0].n_valid)))
        for s in range(1, len(bb.enc_depths)):
            bb.get_submodule(f"enc{s}_down").register_forward_hook(
                lambda m, a, o, s=s: self.counts.append(("points", s,
                                                         o[0].n_valid)))
        build = program.ptv3_module.build_neighbor_map

        def counted(grid_coord, mask, *args, **kwargs):
            nbr = build(grid_coord, mask, *args, **kwargs)
            self.counts.append(("pairs", None, (nbr >= 0).sum()))
            return nbr
        program.ptv3_module.build_neighbor_map = counted

    def start_trace(self) -> None:
        """After the warm-up: forget its spans and counts, start the
        profiler."""
        self.counts.clear()
        self.spans.clear()
        program.tracing.clear()
        self.prof = trace.profiler(self.device)
        self.prof.start()

    def close_trace(self) -> None:
        """At the end of the traced part: wait for the device, stop the
        profiler."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.trace_ns.append(time.time_ns())
        self.prof.stop()
        self.stopped, self.prof = self.prof, None
        self.traced_counts = len(self.counts)
        self.traced_spans = list(self.spans.host)
        self.program_snap = program.tracing.snapshot()
        program.tracing.disable()
        program.tracing.clear()

    def traced_measures(self) -> Dict:
        """The trace's reduction with the program's spans beside the
        harness's, the harness's spans and stage counts, and the program's
        spans (summed and their own time) and counters by request or
        step."""
        snap = self.program_snap
        ms, counts = program_trace.per_root(snap)
        return {"trace": program_trace.reduce(
                    self.stopped, tuple(self.trace_ns), self.traced_spans,
                    snap),
                "spans_ms": self.spans.ms(), "stage_counts": self.stages(),
                "program_spans_ms": ms, "program_counters": counts,
                "program_self_ms": program_trace.self_ms(snap)}

    def stages(self) -> List[Dict]:
        """Per forward of the traced part: live points of each stage, the
        kernel-map pairs of each stage and the scene's live points
        (``live``)."""
        per, cur = [], None
        for kind, s, v in self.counts[:self.traced_counts]:
            if kind == "points" and s == 0:
                cur = {"points": {}, "pairs": []}
                per.append(cur)
            if kind == "pairs":
                cur["pairs"].append(float(v))
            elif kind == "live":
                cur["live"] = float(v)
            else:
                cur["points"][s] = float(v)
        return per
