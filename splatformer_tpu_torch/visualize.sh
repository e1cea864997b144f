#!/bin/sh
# Attention visualization sweep on the card (port of scripts/visualize.sh):
# the per-head attention replay over the merging algorithms, PLY + HTML
# out. Usage, from anywhere:
#     sh splatformer_tpu_torch/visualize.sh [merge_rate] [out_dir]
# out_dir is relative to the repo root (default output/visualization).
set -e
cd "$(dirname "$0")/.."
RATE=${1:-0.5}
OUT=${2:-output/visualization}
python -m splatformer_tpu_torch.visualize --algos base tome patch important_patch \
    --merge_rate "$RATE" --out "$OUT"
