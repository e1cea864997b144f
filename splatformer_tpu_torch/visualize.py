"""Attention visualizer (port of the repo-root visualize.py).

For each merging algorithm, replays attention blocks per head with and
without merging (utils/attn_replay.py, proportional attention
``attn + log(size)`` included) and exports coloured point clouds:

  * per-head PCA colourings of the merged-path and base-path attention
    features;
  * per-head |merged - base| difference maps (``diff_*``);
  * merge-group colourings (``merge_*``), a random colour per merged
    token, on the merged tokens or, with ``--trace_back``, traced back to
    the original points;

then ``index.html`` (links to the PLYs) and ``viewer.html`` (every cloud
in one self-contained WebGL page, utils/webviewer.py).

    python -m splatformer_tpu_torch.visualize --out output/visualization
    python -m splatformer_tpu_torch.visualize --cpu --out output/vis_cpu

The weights are the port's seeded initialisation (seed 0), as the JAX
visualizer's are ``model.init``'s; the scene is ``random_scene`` of seed
0. Runs on the card unless ``--cpu``; without a card it exits 1. Output
goes under ``--out`` only.
"""
import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def pca_color(feat: np.ndarray) -> np.ndarray:
    """(N, C) features -> (N, 3) uint8 PCA colours."""
    x = feat - feat.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    p = x @ vt[:3].T
    p = (p - p.min(axis=0)) / (np.ptp(p, axis=0) + 1e-9)
    return (p * 255).astype(np.uint8)


_HTML = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>splatformer_tpu attention visualization</title></head><body>
<h2>Attention visualization</h2>
<p>Colored point clouds (PCA of per-block attention features and
merged-vs-base differences). Load the .ply files below in any point-cloud
viewer (e.g. three.js PLYLoader, MeshLab, CloudCompare):</p>
<ul>{items}</ul></body></html>"""


def export_cloud(path: str, coords: np.ndarray, colors: np.ndarray):
    from splatformer_tpu_torch.utils.viewer import write_ply
    write_ply(path, {
        "x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2],
        "red": colors[:, 0].astype(np.float32) / 255.0,
        "green": colors[:, 1].astype(np.float32) / 255.0,
        "blue": colors[:, 2].astype(np.float32) / 255.0,
    })


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ptv3_base")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--algos", nargs="+",
                   default=["base", "tome", "patch", "important_patch"])
    p.add_argument("--merge_rate", type=float, default=0.5)
    p.add_argument("--out", default="visualization")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--n_gaussians", type=int, default=4096)
    p.add_argument("--blocks", nargs="*", default=["enc0_block0"],
                   help="attention blocks to replay (substring match; "
                        "empty = all)")
    p.add_argument("--trace_back", action="store_true",
                   help="trace merge-group colorings back to the original "
                        "points (overrides the config knob)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("visualize: no CUDA device is available (pass --cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")

    from splatformer_tpu_torch.configs import build_full_config
    from splatformer_tpu_torch.data.synthetic import random_scene
    from splatformer_tpu_torch.models.feature_predictor import (
        build_feature_predictor)
    from splatformer_tpu_torch.utils.attn_replay import replay_model
    from splatformer_tpu_torch.utils.webviewer import (
        export_interactive_viewer)

    os.makedirs(args.out, exist_ok=True)
    scene = random_scene(np.random.default_rng(0), args.n_gaussians,
                         sh_degree=1, device=device)

    items = []
    clouds = {}

    def export_both(fname, coords, colors_u8):
        export_cloud(os.path.join(args.out, fname), coords, colors_u8)
        items.append(fname)
        clouds[fname[:-4]] = (coords, colors_u8)

    base_feats = {}
    for algo in args.algos:
        cfg = build_full_config(args.model, args.dataset, "default")
        info = cfg.model.additional_info
        info["tome"] = algo
        info["r"] = 0.0 if algo == "base" else args.merge_rate
        if args.trace_back:
            info["trace_back"] = True
        model = build_feature_predictor(cfg.model, device=device, seed=0)
        bk = cfg.model.backbone.backbone_kwargs()
        replays = replay_model(model, scene, bk, bk["enc_patch_size"][0],
                               additional_info=dict(info),
                               blocks=args.blocks or None)

        for path, rep in replays.items():
            key = path.replace("/", "_")
            coords = rep["coord"]
            n_heads = len(rep["attn_feats"])
            for hi in range(n_heads):
                export_both(f"{algo}_{key}_h{hi}.ply", coords,
                            pca_color(rep["attn_feats"][hi]))
                if algo == "base":
                    base_feats[(key, hi)] = rep["ori_attn_feats"][hi]
                elif (key, hi) in base_feats:
                    # per-head |merged - base| difference (red = changed)
                    diff = np.abs(rep["attn_feats"][hi]
                                  - base_feats[(key, hi)]).sum(
                                      axis=1, keepdims=True)
                    d = (diff / (diff.max() + 1e-9) * 255).astype(np.uint8)
                    dc = np.concatenate([d, np.zeros_like(d), 255 - d],
                                        axis=1)
                    export_both(f"diff_{algo}_{key}_h{hi}.ply", coords, dc)
                if rep["merged_colors"] is not None:
                    mc = (np.clip(rep["merged_colors"][hi], 0, 1)
                          * 255).astype(np.uint8)
                    mco = rep["merged_coords"][hi]
                    export_both(f"merge_{algo}_{key}_h{hi}.ply", mco, mc)
            if rep.get("size") is not None:
                print(f"{algo} {key}: {rep['n_effective_tokens']}"
                      f"/{rep['n_tokens']} effective tokens")

    with open(os.path.join(args.out, "index.html"), "w") as f:
        f.write(_HTML.format(items="".join(
            f"<li><a href='{i}'>{i}</a></li>" for i in items)))
    export_interactive_viewer(
        os.path.join(args.out, "viewer.html"), clouds,
        title=f"attention visualization ({args.model})")
    print(f"wrote {len(items)} clouds + index.html + viewer.html "
          f"to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
