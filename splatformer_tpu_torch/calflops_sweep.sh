#!/bin/sh
# The FLOPs sweep of gflops.csv on the card (port of
# scripts/calflops_sweep.sh): python -m splatformer_tpu_torch.calflops over
# every merging mode x rate, rows 'gflops,algo,r' into $CSV (default
# $OUT/gflops.csv, never the repo's gflops.csv) and the effective-token
# companion into $OUT/gflops_tokens.csv. N=16384 Gaussians a scene (the
# oodbench training tier), $SCENES scenes a row; one base row at 65,536
# Gaussians, labelled base_65k as in gflops.csv, anchors the scale tier.
#
#     OUT=output/calflops sh splatformer_tpu_torch/calflops_sweep.sh
#     DEV=--cpu OUT=output/calflops_cpu sh splatformer_tpu_torch/calflops_sweep.sh
#
# Rows already in $CSV are skipped, so a cut sweep continues.
set -e
cd "$(dirname "$0")/.."
OUT=${OUT:-output/calflops}
N=${N:-16384}
SCENES=${SCENES:-2}
CSV=${CSV:-$OUT/gflops.csv}
DEV=${DEV:-}

run() {
  python -m splatformer_tpu_torch.calflops $DEV --num_scenes "$SCENES" \
    --csv "$CSV" --override dataset.n_gaussians="$N" \
    --override dataset.pad_to="$N" "$@"
}

have() { [ -f "$CSV" ] && grep -q ",$1,$2\$" "$CSV"; }

have base 0.0 || run --model ptv3_base
for ALGO in tome pitome tofu prune patch wpatch algm; do
  for RATE in 0.1 0.3 0.5 0.7 0.9; do
    have "$ALGO" "$RATE" || run --model "ptv3_$ALGO" --merge_rate "$RATE"
  done
done
# the scale-tier anchor (65,536-Gaussian scenes)
have base_65k 0.0 || N=65536 SCENES=1 run --model ptv3_base --label base_65k
echo "calflops sweep complete -> $CSV"
