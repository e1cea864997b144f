"""Arithmetic the metric readers share: the traced forwards' time at the
peaks (the ``mfu`` metrics), K3's least time (the ``*_roofline`` metrics),
device time by kernel name, the program's own spans and counters of the
traced part (``program_span_ms``, ``program_counter``,
``device_within_s``), and input downsampling's time and least time
(``downsample_ms``, ``downsample_bound_s``)."""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

from perfbench.lib import counters
from perfbench.reference.steps import backbone_kwargs, head_channels


def _model(run) -> Dict:
    return run.cell["config"]["model"]


def flash(run) -> bool:
    return bool(_model(run)["backbone"]["enable_flash"])


def bf16(run) -> bool:
    return bool(run.cell["traffic"].get("recipe", {}).get("bf16", False))


def stage_points(rec: Dict, n_stages: int) -> Dict[str, float]:
    pts = {f"enc{s}": rec["points"][s] for s in range(n_stages)}
    pts.update({f"dec{s}": rec["points"][s] for s in range(n_stages - 1)})
    return pts


def forward_peak_s(run, rec: Dict) -> float:
    """Seconds one forward's FLOPs (and, in training, its backward's at
    twice the forward and LPIPS's) would take at the peak of the class each
    runs in: float32 outside the tensor cores where TF32 is off, bfloat16
    on the tensor cores for the blocks of a bf16 step, K3's float32 as
    TF32_SPLIT TF32 products."""
    model = _model(run)
    bk = backbone_kwargs(model["backbone"])
    n_stages = len(bk["enc_depths"])
    f = counters.model_flops(bk, head_channels(model),
                             stage_points(rec, n_stages), rec["pairs"],
                             model["additional_info"], rec["live"])
    train = run.kind == "train"
    low = train and bf16(run)
    block_peak = counters.PEAK_BF16 if low else counters.PEAK_F32
    if flash(run):
        attn_peak = (counters.PEAK_BF16 if low else
                     counters.PEAK_TF32 / counters.TF32_SPLIT)
    else:
        attn_peak = counters.PEAK_F32
    s = (f["block_dense"] / block_peak + f["outside_dense"] / counters.PEAK_F32
         + f["attn_products"] / attn_peak)
    if not train:
        return s
    tr = run.cell["traffic"]
    lp = 0.0
    if tr["recipe"]["lpips_loss_weight"] > 0:
        # both images forward, the prediction's input gradient backward
        lp = 3 * counters.lpips_flops(tr["views"], tr["height"], tr["width"])
    return 3 * s + lp / counters.PEAK_F32


def mfu(run, downsampling: bool = False) -> Optional[float]:
    """% of the peak: the traced forwards' mean time at the peaks over the
    median time of the window's requests or steps (the median, since the
    profiled ones among them run slower). With ``downsampling``, FPS's and
    the nearest search's FP32 operations (``fps_picks``) at the FP32 peak
    besides."""
    if (not getattr(run, "stage_counts", None) or not run.done
            or run.trace["busy_s"] <= 0):
        return None
    at_peak = [forward_peak_s(run, rec) for rec in run.stage_counts]
    if downsampling:
        picks = fps_picks(run)
        if not picks:
            return None
        at_peak = [s + (counters.fps_work(n, m)[0]
                        + counters.nearest_work(n, m)[0]) / counters.PEAK_F32
                   for s, (n, m) in zip(at_peak, picks)]
    times = run.latencies_s if run.kind == "serve" else run.step_s
    return 100.0 * (sum(at_peak) / len(at_peak)) / statistics.median(times)


def device_s(run, part: str) -> float:
    return sum(s for name, (_, s) in run.trace["kernels"].items()
               if part in name)


def k3_roofline(run, backward: bool) -> Optional[float]:
    """% of K3's least time over its device time in the traced part: the
    forward's calls (and with ``backward`` the backward's) of each traced
    forward, each call bound by the larger of its operations and bytes."""
    if not flash(run) or not getattr(run, "stage_counts", None):
        return None
    parts: List[str] = ["attention_fwd"] + (["attention_bwd"] if backward
                                            else [])
    dev = sum(device_s(run, p) for p in parts)
    if dev <= 0:
        return None
    model = _model(run)
    bk = backbone_kwargs(model["backbone"])
    rows = counters.backbone_rows(model["additional_info"],
                                  run.cell["config"]["scene"]["pad_to"])
    low = run.kind == "train" and bf16(run)
    bound = counters.k3_forward_bound_s(bk, rows, low, False)
    if backward:
        bound += counters.k3_forward_bound_s(bk, rows, low, True)
    return 100.0 * bound * len(run.stage_counts) / dev


def span_mean_ms(run, name: str) -> Optional[float]:
    ms = getattr(run, "spans_ms", {}).get(name)
    return sum(ms) / len(ms) if ms else None


def idle_share(run) -> Optional[float]:
    t = getattr(run, "trace", None)
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _roots(run, key: str) -> List[Dict[str, float]]:
    return getattr(run, key, None) or []


def program_span_ms(run, name: str) -> Optional[float]:
    """The mean ms a request or step of the traced part spent in the
    program's spans named ``name`` (summed where it opens several times),
    or None where no request or step opened one."""
    roots = _roots(run, "program_spans_ms")
    if not any(name in r for r in roots):
        return None
    return sum(r.get(name, 0.0) for r in roots) / len(roots)


def program_counter(run, name: str) -> Optional[float]:
    """The mean a request or step of the program's counter ``name`` over
    the traced part, or None where none recorded it."""
    vals = [r[name] for r in _roots(run, "program_counters") if name in r]
    return sum(vals) / len(vals) if vals else None


def device_within_s(run, name: str) -> Optional[float]:
    """The mean device seconds a request or step of the kernels launched
    inside the program's spans named ``name``, at any depth, or None where
    the trace placed none there."""
    t = getattr(run, "trace", None) or {}
    s = (t.get("device_within") or {}).get(name)
    roots = _roots(run, "program_spans_ms")
    return s / len(roots) if s and roots else None


def fps_picks(run) -> List[Tuple[float, int]]:
    """(live points, centroids) of each traced forward of an FPS
    configuration (reference/downsample.py:fps_knn_downsample: int(slots x
    ratio) picks, at most the live points), or [] for any other."""
    info = _model(run)["additional_info"]
    if info.get("downsample") != "fps" or not getattr(run, "stage_counts",
                                                       None):
        return []
    m = max(1, int(run.cell["config"]["scene"]["pad_to"]
                   * float(info["downsample_ratio"])))
    return [(rec["live"], min(m, int(rec["live"])))
            for rec in run.stage_counts]


def downsample_bound_s(run) -> Optional[float]:
    """The mean least time a traced request of FPS and the nearest search
    (``fps_bound_s`` + ``nearest_bound_s``), or None without FPS."""
    picks = fps_picks(run)
    if not picks:
        return None
    return sum(counters.fps_bound_s(n, m) + counters.nearest_bound_s(n, m)
               for n, m in picks) / len(picks)


def downsample_ms(run) -> Optional[float]:
    """Input downsampling's mean ms a request or step of the traced part:
    the program's ``refine.downsample`` span where it has one, else the
    ``refine`` span's own time, or None without downsampling."""
    if not _model(run)["additional_info"].get("downsample"):
        return None
    ms = program_span_ms(run, "refine.downsample")
    if ms is not None:
        return ms
    roots = _roots(run, "program_self_ms")
    if not any("refine" in r for r in roots):
        return None
    return sum(r.get("refine", 0.0) for r in roots) / len(roots)
