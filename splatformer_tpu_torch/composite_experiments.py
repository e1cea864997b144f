"""What the compositing kernels K1 and K2 spend their time on: variants of
their sources, timed in turns.

    python -m splatformer_tpu_torch.composite_experiments  # needs a GPU, nvcc

Each variant is a copy of csrc/composite_fwd.cu or csrc/composite_bwd.cu,
with csrc/composite_common.cuh pasted in place of its include, and one named
edit, built for sm_90a with the source's own flags into
build/kernels/experiments/ (one nvcc per variant, all started together) and
launched through kernels/composite.py's ``launch_fwd`` and ``launch_bwd``.
The input is chip_smoke.py's k1/k2 input: the port's entries of a
100k-Gaussian ``random_scene`` (seed 0) under 4 orbit views at 256^2, and a
seeded cotangent for K2. Every variant is held against the committed kernel
on that input (K1's out and walked, K2's d_packed: largest difference) and
timed by CUDA events: the mean of 20 launches after a warm-up, best of two
rounds, the variants in order and then in reverse. One JSON line with the
tiles' work, one a kernel and variant, then the card's name and power
limit.

Variants (K1 and K2):
  as_committed   the source as it stands;
  no_cull        every (entry, box) kept: the warps walk every entry, as
                 before the cull (what the cull saves);
  natural_order  CTA b composites tile b, without the heaviest-first order
                 (what the order saves);
K1 only:
  group_1        one kept entry a step instead of 2 (what the interleaved
                 alphas save), and group_4, four;
K2 only:
  batch_128      128 entries a batch instead of 64.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from splatformer_tpu_torch.kernels.build import (BUILD_DIR, CSRC_DIR,
                                                 NVCC_FLAGS, SOURCES,
                                                 nvcc_path)
from splatformer_tpu_torch.kernels.composite import (bind, composite_bwd,
                                                     composite_fwd,
                                                     launch_bwd, launch_fwd,
                                                     warp_box_keep_plain,
                                                     warp_box_max)

SCENE_N, VIEWS, HW = 100_000, 4, 256
TILES_X, TILES_IMG = HW // 16, (HW // 16) ** 2
THR, MAX_ALPHA, EPS_T = 1.0 / 255.0, 0.999, 1e-4

_NO_CULL = ("keep[w][e] = !(testable", "keep[w][e] = true || !(testable")
_NATURAL = ("const int t = heaviest_first(tile_start);",
            "const int t = blockIdx.x;")
_GROUP = "constexpr int kGroup = 2;"
# kernel library -> variant -> [(text of the source, its replacement), ...]
VARIANTS = {
    "composite_fwd": {
        "as_committed": [],
        "no_cull": [_NO_CULL],
        "natural_order": [_NATURAL],
        "group_1": [(_GROUP, "constexpr int kGroup = 1;")],
        "group_4": [(_GROUP, "constexpr int kGroup = 4;")],
    },
    "composite_bwd": {
        "as_committed": [],
        "no_cull": [_NO_CULL],
        "natural_order": [_NATURAL],
        "batch_128": [("constexpr int kBatch = 64;",
                       "constexpr int kBatch = 128;")],
    },
}


_INCLUDE = '#include "composite_common.cuh"'


def variant_source(lib: str, name: str) -> str:
    src = (CSRC_DIR / SOURCES[lib]).read_text().replace(
        _INCLUDE, (CSRC_DIR / "composite_common.cuh").read_text())
    for old, new in VARIANTS[lib][name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {lib} {name}: the source no longer "
                             f"holds {old!r} exactly once")
        src = src.replace(old, new)
    return src


def build_variants():
    """(lib, name) -> ctypes library of every variant, built in parallel."""
    out = BUILD_DIR / "experiments"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, names in VARIANTS.items():
        for name in names:
            src = out / f"{lib}_{name}.cu"
            src.write_text(variant_source(lib, name))
            path = out / f"lib{lib}_{name}.so"
            procs[lib, name] = (path, subprocess.Popen(
                [str(nvcc_path()), *NVCC_FLAGS[lib], "-o", str(path),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (lib, name), (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib} {name}:\n{log}")
        libs[lib, name] = bind(ctypes.CDLL(str(path)))
    return libs


def _call(lib, variant, packed_t, tile_start, saved):
    """Launch one variant: K1 gives (out, walked), K2 (d_packed,) from
    ``saved`` = (out, walked, g_out)."""
    if lib == "composite_fwd":
        return launch_fwd(variant, packed_t, tile_start, TILES_X, TILES_IMG,
                          THR, MAX_ALPHA, EPS_T)
    return (launch_bwd(variant, packed_t, tile_start, TILES_X, TILES_IMG,
                       *saved, THR, MAX_ALPHA),)


def tile_work(packed_t, tile_start, walked):
    """Per tile: its longest walk and its kept warp-iterations (each warp
    box's kept entries below the box's longest walk)."""
    keep = warp_box_keep_plain(packed_t, tile_start, TILES_X, TILES_IMG, THR)
    reach = warp_box_max(walked.long())                         # (T, 8)
    j = torch.arange(keep.shape[2], device=keep.device)
    kept = (keep & (j < reach[..., None])).sum(dim=(1, 2))
    return walked.max(dim=1).values, kept


def main():
    if not torch.cuda.is_available():
        raise SystemExit("composite_experiments needs a CUDA device")
    from splatformer_tpu_torch.data.synthetic import (orbit_cameras,
                                                      random_scene)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig

    libs = build_variants()
    scene = random_scene(np.random.default_rng(0), SCENE_N, sh_degree=1)
    e = prepare_entries(scene, orbit_cameras(VIEWS, HW, HW),
                        RasterizeConfig())
    packed_t, tile_start = e.packed_t.contiguous(), e.tile_start.contiguous()
    out, walked = composite_fwd(packed_t, tile_start, TILES_X, TILES_IMG)
    longest, kept = tile_work(packed_t, tile_start, walked)
    print(json.dumps({
        "tiles": int(longest.numel()),
        "longest_walk_mean": float(longest.float().mean()),
        "longest_walk_max": int(longest.max()),
        "kept_warp_iterations": int(kept.sum()),
        "kept_warp_iterations_tile_mean": float(kept.float().mean()),
        "kept_warp_iterations_tile_max": int(kept.max()),
        "share_in_heaviest_tenth": float(
            kept.sort(descending=True).values[:len(kept) // 10].sum()
            / kept.sum())}), flush=True)
    g_out = torch.randn(out.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    saved = (out, walked, g_out)
    refs = {"composite_fwd": (out, walked),
            "composite_bwd": (composite_bwd(packed_t, tile_start, TILES_X,
                                            TILES_IMG, *saved),)}
    for lib, names in VARIANTS.items():
        rows = {}
        for n in names:
            got = _call(lib, libs[lib, n], packed_t, tile_start, saved)
            torch.cuda.synchronize()
            rows[n] = {"kernel": lib, "variant": n, "max_abs_diff": max(
                float((g.float() - r.float()).abs().max())
                for g, r in zip(got, refs[lib])), "ms": float("inf")}
        for n in list(names) + list(names)[::-1]:
            _call(lib, libs[lib, n], packed_t, tile_start, saved)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                _call(lib, libs[lib, n], packed_t, tile_start, saved)
            stop.record()
            torch.cuda.synchronize()
            rows[n]["ms"] = min(rows[n]["ms"], start.elapsed_time(stop) / 20)
        for r in rows.values():
            print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
