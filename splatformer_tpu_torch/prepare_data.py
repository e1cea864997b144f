"""Offline data prep (port of scripts/prepare_data.py): convert scene pairs
(a nerfstudio splatfacto checkpoint and a COLMAP folder) into pickle-free
npz caches (data/nerfstudio.py:convert_scene_to_npz) for fast loading.
Host only: numpy and torch.load, no device.

    python -m splatformer_tpu_torch.prepare_data \\
        --nerfstudio train-set/objaverseOOD/nerfstudio \\
        --colmap train-set/objaverseOOD/colmap --out cache/objaverseOOD

A scene whose npz exists is skipped; a scene that fails to convert is
reported and skipped.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nerfstudio", required=True)
    ap.add_argument("--colmap", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--load_pose_src", default="nerfstudio")
    ap.add_argument("--max_gs_num", type=int, default=100_000)
    ap.add_argument("--remove_outlier_ndevs", type=float, default=-1.0)
    args = ap.parse_args(argv)

    from splatformer_tpu_torch.data.nerfstudio import convert_scene_to_npz

    os.makedirs(args.out, exist_ok=True)
    for name in sorted(os.listdir(args.nerfstudio)):
        ns_dir = os.path.join(args.nerfstudio, name, "splatfacto")
        cm_dir = os.path.join(args.colmap, name)
        out_path = os.path.join(args.out, f"{name}.npz")
        if os.path.exists(out_path):
            continue
        try:
            convert_scene_to_npz(
                ns_dir, cm_dir, out_path,
                load_pose_src=args.load_pose_src,
                max_gs_num=args.max_gs_num,
                remove_outlier_ndevs=args.remove_outlier_ndevs)
            print("converted", name, flush=True)
        except (OSError, ValueError, KeyError, AssertionError) as e:
            print("FAILED", name, e, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
