"""What binds the float32 K3 kernels: variants of each, timed in turns.

    python -m splatformer_tpu_torch.k3_experiments [--pass fwd|bwd|both]
    # needs a GPU and nvcc; both passes by default

Each variant is a copy of csrc/attention_fwd.cu (forward) or
csrc/attention_bwd.cu (backward) with named edits to its split-TF32
kernels (``attention_fwd_tf32x3_kernel``; ``attention_bwd_dq_tf32x3_kernel``
and ``attention_bwd_dkv_tf32x3_kernel``), built for sm_90a with the
source's own flags into build/kernels/experiments/ (one nvcc per variant,
all started together). On each of PTv3-base's flash-path shape classes
(chip_smoke.py's K3_CLASSES, seeded q, k, v and cotangent as its k3 phases
make them) every variant is checked against the plain version and timed by
CUDA events: the mean of 20 launches after a warm-up, best of two rounds,
the variants run in order and then in reverse. One JSON line a variant: its
pass, its largest errors (forward: o relative to its largest magnitude,
lse absolute; backward: the largest of dq, dk and dv relative to their
own largest magnitudes, and each), ms a launch per class and ms a pass (22
launches), then the card's name and power limit.

Forward variants:
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
Backward variants (both passes each):
  as_committed, one_product, half_b_reads  as above;
  one_accumulator  dQ, dK and dV summed across all tiles by the tensor
                   cores, without their per-tile accumulators (accuracy);
  split_once       the split pass run on the first tile only (wrong
                   results): its share of the time;
  unroll_2         the loop over a tile's 8-row steps unrolled 2 times
                   instead of 8 (fewer independent mma chains in reach of
                   the scheduler, fewer registers);
  four_warps       4 warps (64 rows) a CTA instead of 8 (128 rows): the
                   split pass shared by half as many rows;
  four_warps_min_blocks  that, with a launch-bounds minimum of the CTAs an
                   SM that the shared memory allows (the registers capped
                   to fit them); the committed kernels set no minimum.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from splatformer_tpu_torch.kernels.attention import (attention_bwd_plain,
                                                     attention_fwd_plain)
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
_ONE_PRODUCT = [(_MMA3, (
    '  asm volatile("" ::"r"(b.z), "r"(b.w), "r"(a_lo[0]), '
    '"r"(a_lo[1]),\n               "r"(a_lo[2]), "r"(a_lo[3]));\n'
    "  mma1688(d, a_hi, b.x, b.y);"))]
_KR = "const float* kr = kf + (8 * j + g) * L::kKStride + 4 * t;"
_VR = "const float* vr = vf + (4 * j + t) * L::kVStride + 4 * g;"
_BOUNDS = """__global__ void __launch_bounds__(kThreads, D == 16 ? 4 : 3)
attention_fwd_tf32x3_kernel("""
_BWD_BOUNDS = ("__launch_bounds__(kF32Threads)\nattention_bwd_dq_",
               "__launch_bounds__(kF32Threads)\nattention_bwd_dkv_")
# the CTAs an SM that 4-warp CTAs' shared memory allows: dQ 5, 4, 3 and
# dK/dV 4, 3, 2 at D = 16, 24, 32
_MIN_BLOCKS = ("D == 16 ? 5 : (D == 24 ? 4 : 3)",
               "D == 16 ? 4 : (D == 24 ? 3 : 2)")
_FOUR_WARPS = [("constexpr int kF32Warps = 8;", "constexpr int kF32Warps = 4;")]
_B_ROWS = ("const float* kr = kk + (8 * j + g) * L::kKStride + 4 * t;",
           "const float* vr = vk + (8 * j + g) * L::kKStride + 4 * t;",
           "const float* qr = qk + (8 * j + g) * L::kKStride + 4 * t;",
           "const float* dr = dok + (8 * j + g) * L::kKStride + 4 * t;",
           "const float* kvr = kv + (4 * j + t) * L::kVStride + 4 * g;",
           "const int vrow = (4 * j + t) * L::kVStride + 4 * g;")
_J_LOOPS = ("#pragma unroll\n    for (int j = 0; j < 8; ++j) {  // keys",
            "#pragma unroll\n    for (int j = 0; j < 8; ++j) {  // queries")
_SPLITS = ("    split_tile<D, true>(kk, kv, raw_k);\n"
           "    split_tile<D, false>(vk, nullptr, raw_v);\n",
           "    split_tile<D, true>(qk, qv, raw_q);\n"
           "    split_tile<D, true>(dok, dov, raw_do);\n")

# pass -> variant -> [(text of the source, its replacement), ...]
VARIANTS = {
    "fwd": {
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
        "one_product": _ONE_PRODUCT,
        "half_b_reads": [(_KR, _KR.replace("8 * j", "8 * (j & 3)")),
                         (_VR, _VR.replace("4 * j", "4 * (j & 3)"))],
        "no_min_blocks": [(_BOUNDS,
                           _BOUNDS.replace(", D == 16 ? 4 : 3", ""))],
    },
    "bwd": {
        "as_committed": [],
        "one_accumulator": [
            ("        mma_3xtf32(dqt[n], ah, al,",
             "        mma_3xtf32(acc[n], ah, al,"),
            ("      for (int e = 0; e < 4; ++e) acc[n][e] += dqt[n][e];",
             "      for (int e = 0; e < 4; ++e) dqt[n][e] = 0.f;"),
            ("        mma_3xtf32(dvt[n], ah, al,",
             "        mma_3xtf32(dva[n], ah, al,"),
            ("        mma_3xtf32(dkt[n], ah, al,",
             "        mma_3xtf32(dka[n], ah, al,"),
            ("        dka[n][e] += dkt[n][e];\n        dva[n][e] += dvt[n][e];",
             "        dkt[n][e] = dvt[n][e] = 0.f;")],
        "one_product": _ONE_PRODUCT,
        "half_b_reads": [(r, r.replace("* j", "* (j & 3)")) for r in _B_ROWS],
        "split_once": [(x, "    if (it == 0) {\n" + x + "    }\n")
                       for x in _SPLITS],
        "unroll_2": [(x, x.replace("unroll", "unroll 2")) for x in _J_LOOPS],
        "two_ctas": [(b, b.replace("kF32Threads)",
                                   "kF32Threads, D == 32 ? 1 : 2)"))
                     for b in _BWD_BOUNDS],
        "four_warps": _FOUR_WARPS,
        "four_warps_min_blocks": _FOUR_WARPS + [
            (b, b.replace("kF32Threads)", f"kF32Threads, {m})"))
            for b, m in zip(_BWD_BOUNDS, _MIN_BLOCKS)],
    },
}
_LIBRARY = {"fwd": "attention_fwd", "bwd": "attention_bwd"}
_ARGTYPES = {"fwd": 5 * [ctypes.c_void_p] + 4 * [ctypes.c_int],
             "bwd": 10 * [ctypes.c_void_p] + 4 * [ctypes.c_int]}


def variant_source(pass_: str, name: str) -> str:
    src = (CSRC_DIR / SOURCES[_LIBRARY[pass_]]).read_text()
    for old, new in VARIANTS[pass_][name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {pass_} {name}: the source no longer "
                             f"holds {old!r} exactly once")
        src = src.replace(old, new)
    return src


def build_variants(pass_: str):
    """name -> ctypes entry point of every variant of one pass, built in
    parallel."""
    lib_name = _LIBRARY[pass_]
    out = BUILD_DIR / "experiments"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS[pass_]:
        src = out / f"{lib_name}_{name}.cu"
        src.write_text(variant_source(pass_, name))
        lib = out / f"lib{lib_name}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [str(nvcc_path()), *NVCC_FLAGS[lib_name], "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), lib_name)
        fn.argtypes = _ARGTYPES[pass_] + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _case(pass_, b, h, d, seed):
    """(launch(fn), errors()) of one shape class: seeded inputs, the plain
    version's outputs and the buffers every variant writes; errors() holds
    the last launch's outputs against the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, PATCH, d), generator=gen,
                               device="cuda") for _ in range(4))
    q = 2.0 * q
    scale = d ** -0.5
    o_p, lse_p = attention_fwd_plain(q, k, v, scale)
    if pass_ == "fwd":
        outs = (torch.empty_like(q), torch.empty_like(lse_p))

        def launch(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     outs[0].data_ptr(), outs[1].data_ptr(), b * h, PATCH, d,
                     0, scale, _stream())
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        def errors():
            rel = float((outs[0] - o_p).abs().max() / o_p.abs().max())
            return {"max_rel_err": rel,
                    "lse_max_abs_err": float((outs[1] - lse_p).abs().max())}
        return launch, errors

    want = attention_bwd_plain(q, k, v, o_p, lse_p, do, scale)
    di = torch.empty_like(lse_p)
    outs = tuple(torch.empty_like(q) for _ in range(3))

    def launch(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_p.data_ptr(),
                 lse_p.data_ptr(), do.data_ptr(), di.data_ptr(),
                 *(x.data_ptr() for x in outs), b * h, PATCH, d, 0, scale,
                 _stream())
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def errors():
        rel = {f"{n}_rel_err": float((g - w).abs().max() / w.abs().max())
               for n, g, w in zip(("dq", "dk", "dv"), outs, want)}
        return {"max_rel_err": max(rel.values()), **rel}
    return launch, errors


def run_pass(pass_: str):
    fns = build_variants(pass_)
    rows = {n: {"pass": pass_, "variant": n, "max_rel_err": 0.0,
                "ms_pass": 0.0} for n in fns}
    for i, (cls, (b, h, d, blocks)) in enumerate(K3_CLASSES.items()):
        launch, errors = _case(pass_, b, h, d, seed=30 + i)
        for n, fn in fns.items():
            launch(fn)
            torch.cuda.synchronize()
            errs = errors()
            r = rows[n]
            r[cls] = errs
            for key, err in errs.items():
                r[key] = max(r.get(key, 0.0), err)
        ms = {n: float("inf") for n in fns}
        for n in list(fns) + list(fns)[::-1]:
            launch(fns[n])
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch(fns[n])
            stop.record()
            torch.cuda.synchronize()
            ms[n] = min(ms[n], start.elapsed_time(stop) / 20)
        for n in fns:
            rows[n][cls]["ms"] = ms[n]
            rows[n]["ms_pass"] += blocks * ms[n]
        del launch, errors
        torch.cuda.empty_cache()
    for r in rows.values():
        print(json.dumps(r), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pass", dest="pass_", default="both",
                        choices=("fwd", "bwd", "both"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_experiments needs a CUDA device")
    for pass_ in ("fwd", "bwd"):
        if args.pass_ in (pass_, "both"):
            run_pass(pass_)
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
