"""What binds the float32 K3 forward: variants of its kernel, timed in turns.

    python -m splatformer_tpu_torch.k3_experiments  # needs a GPU and nvcc

Each variant is a copy of csrc/attention_fwd.cu with one named edit to the
split-TF32 kernel (``attention_fwd_tf32x3_kernel``), built for sm_90a with
the source's own flags into build/kernels/experiments/ (one nvcc per
variant, all started together). On each of PTv3-base's flash-path shape
classes (chip_smoke.py's K3_CLASSES, seeded q, k, v as its k3 phase makes
them) every variant is checked against the plain version and timed by CUDA
events: the mean of 20 launches after a warm-up, best of two rounds, the
variants run in order and then in reverse. One JSON line a variant: its
largest errors (o relative to its largest magnitude, lse absolute), ms a
launch per class and ms a forward (22 launches), then the card's name and
power limit.

Variants:
  as_committed     the source as it stands;
  cvt_rna          TF32 rounding by the PTX ``cvt.rna.tf32.f32`` instead of
                   the two integer operations;
  one_accumulator  P V summed into O across all tiles by the tensor cores,
                   without the per-tile accumulator (accuracy);
  one_product      only a_hi b_hi issued, the split and the loads kept live
                   (wrong results): the tensor pipe's share of the time;
  half_b_reads     each warp reads half of the split tiles' B fragments
                   (wrong results): the shared-memory reads' share;
  no_min_blocks    ``__launch_bounds__(128)`` without the CTAs an SM that
                   the compiler keeps registers for.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from splatformer_tpu_torch.kernels.attention import attention_fwd_plain
from splatformer_tpu_torch.kernels.build import (BUILD_DIR, CSRC_DIR,
                                                 NVCC_FLAGS, SOURCES,
                                                 nvcc_path)

# shape class -> (B patches, H heads, d, blocks a forward), patch 1024
K3_CLASSES = {"enc0": (98, 2, 32, 2), "enc1_dec1_dec0": (98, 4, 24, 6),
              "enc2_dec2": (74, 8, 16, 4), "enc3_dec3": (47, 16, 16, 8),
              "enc4": (24, 32, 16, 2)}
PATCH = 1024

_MMA3 = """  mma1688(d, a_lo, b.x, b.y);
  mma1688(d, a_hi, b.z, b.w);
  mma1688(d, a_hi, b.x, b.y);"""
_KR = "const float* kr = kf + (8 * j + g) * L::kKStride + 4 * t;"
_VR = "const float* vr = vf + (4 * j + t) * L::kVStride + 4 * g;"
_BOUNDS = """__global__ void __launch_bounds__(kThreads, D == 16 ? 4 : 3)
attention_fwd_tf32x3_kernel("""

# variant -> [(text of the source, its replacement), ...]
VARIANTS = {
    "as_committed": [],
    "cvt_rna": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        '  uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(y) : '
        '"f"(x));\n  return y;')],
    "one_accumulator": [
        ("      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;",
         "      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];"),
        ("        mma_3xtf32(pv[n], ph, pl,",
         "        mma_3xtf32(acc[n], ph, pl,"),
        ("        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);",
         "        pv[n][e] = 0.f;")],
    "one_product": [(_MMA3, (
        '  asm volatile("" ::"r"(b.z), "r"(b.w), "r"(a_lo[0]), '
        '"r"(a_lo[1]),\n               "r"(a_lo[2]), "r"(a_lo[3]));\n'
        "  mma1688(d, a_hi, b.x, b.y);"))],
    "half_b_reads": [(_KR, _KR.replace("8 * j", "8 * (j & 3)")),
                     (_VR, _VR.replace("4 * j", "4 * (j & 3)"))],
    "no_min_blocks": [(_BOUNDS, _BOUNDS.replace(", D == 16 ? 4 : 3", ""))],
}


def variant_source(name: str) -> str:
    src = (CSRC_DIR / SOURCES["attention_fwd"]).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old!r} exactly once")
        src = src.replace(old, new)
    return src


def build_variants():
    """name -> ctypes attention_fwd of every variant, built in parallel."""
    out = BUILD_DIR / "experiments"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = out / f"attention_fwd_{name}.cu"
        src.write_text(variant_source(name))
        lib = out / f"libattention_fwd_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [str(nvcc_path()), *NVCC_FLAGS["attention_fwd"], "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _launch(fn, q, k, v, o, lse, scale):
    b, h, seq, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b * h, seq, d, 0, scale,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k3_experiments needs a CUDA device")
    fns = build_variants()
    rows = {n: {"variant": n, "max_rel_err": 0.0, "lse_max_abs_err": 0.0,
                "ms_forward": 0.0} for n in fns}
    for i, (cls, (b, h, d, blocks)) in enumerate(K3_CLASSES.items()):
        gen = torch.Generator(device="cuda").manual_seed(30 + i)
        q, k, v = (torch.randn((b, h, PATCH, d), generator=gen,
                               device="cuda") for _ in range(3))
        q = 2.0 * q
        scale = d ** -0.5
        o_p, lse_p = attention_fwd_plain(q, k, v, scale)
        o, lse = torch.empty_like(q), torch.empty_like(lse_p)
        ms = {n: float("inf") for n in fns}
        for n, fn in fns.items():
            _launch(fn, q, k, v, o, lse, scale)
            torch.cuda.synchronize()
            rel = float((o - o_p).abs().max() / o_p.abs().max())
            lse_err = float((lse - lse_p).abs().max())
            r = rows[n]
            r[cls] = {"max_rel_err": rel, "lse_max_abs_err": lse_err}
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            r["lse_max_abs_err"] = max(r["lse_max_abs_err"], lse_err)
        for n in list(fns) + list(fns)[::-1]:
            _launch(fns[n], q, k, v, o, lse, scale)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                _launch(fns[n], q, k, v, o, lse, scale)
            stop.record()
            torch.cuda.synchronize()
            ms[n] = min(ms[n], start.elapsed_time(stop) / 20)
        for n in fns:
            rows[n][cls]["ms"] = ms[n]
            rows[n]["ms_forward"] += blocks * ms[n]
    for r in rows.values():
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
