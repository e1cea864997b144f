#!/bin/sh
# The token-merging efficiency study on the card, end to end: the data
# factory's scale tier (36 train + 8 held-out scenes, the flags of
# scripts/run_oodbench_scale.sh), PTv3-base trained with
# scripts/run_scale_r5.sh's recipe to step $STEPS (an eval and a best
# checkpoint at 750), --only_eval of that checkpoint at the sweep's pad (the
# base row's check), then python -m splatformer_tpu_torch.eval_sweep over
# every merging and downsampling algorithm at rates 0.1-0.9, then the
# effective tokens of the trained checkpoint (scripts/run_r5_post.sh's
# calflops step: ALGM at 0.1, 0.5, 0.9 and ToMe, PiToMe, pruning at 0.5 on
# 2 held-out scenes at the pad).
#
#     OUT=output/merge_study sh splatformer_tpu_torch/run_merge_study.sh
#
# Writes $OUT/eval_sweep.csv (eval.csv's schema), $OUT/eval.csv (the
# --only_eval row), $OUT/run/ (the training run), $OUT/gflops.csv and
# $OUT/gflops_tokens.csv (the token step) and a log a stage. Done scenes,
# done sweep rows and done token rows are skipped and training resumes from
# its checkpoint, so a cut run continues.
set -e
cd "$(dirname "$0")/.."
ROOT=$(pwd)
OUT=${OUT:-output/merge_study}
STEPS=${STEPS:-751}
PAD=${PAD:-16384}
mkdir -p "$OUT"

have_tokens() {
  [ -f "$OUT/gflops_tokens.csv" ] && grep -q "^$1,$2," "$OUT/gflops_tokens.csv"
}

tokens() {
  for combo in "algm 0.1" "algm 0.5" "algm 0.9" \
               "tome 0.5" "pitome 0.5" "prune 0.5"; do
    set -- $combo
    have_tokens "$1" "$2" && continue
    python -m splatformer_tpu_torch.calflops --model "ptv3_$1" \
        --dataset oodbench_scale --merge_rate "$2" --num_scenes 2 \
        --ckpt "$OUT/run" --override dataset.max_gs_num="$PAD" \
        --override dataset.pad_to="$PAD" --csv "$OUT/gflops.csv"
  done >> "$OUT/tokens.log" 2>&1
  echo "effective tokens: $OUT/gflops_tokens.csv"
}

[ -f weights/lpips_vgg.npz ] || python -c "from splatformer_tpu_torch.models.lpips import write_synthetic_weights as w; w('weights/lpips_vgg.npz')"

python -m splatformer_tpu_torch.make_ood_benchmark --out data/oodbench_scale \
    --n_train_scenes 36 --n_test_scenes 8 --hw 256 --n_gauss 98304 \
    --capacity 65536 --fit_steps 500 --seed_points 49152 \
    --densify_budget_frac 0.08 --fit_warmup 100 --max_intersects 524288 \
    --tiers 8,32768,24,4096 > "$OUT/factory.log" 2>&1

python -m splatformer_tpu_torch.train --dataset oodbench_scale \
    --output_dir "$OUT/run" --max_steps "$STEPS" \
    --override train.total_steps=5000 --override train.eval_interval=750 \
    --override train.optimizer.warmup_steps=200 \
    --override train.optimizer.schedule=cosine \
    --override "train.optimizer.lr_dict={'base': 7e-5, 'backbone': 7e-5}" \
    > "$OUT/train.log" 2>&1

# --only_eval appends to ./eval.csv: run it from $OUT, beside links to the
# data and the LPIPS weights
ln -sfn "$ROOT/data" "$OUT/data"
ln -sfn "$ROOT/weights" "$OUT/weights"
(cd "$OUT" && PYTHONPATH="$ROOT" python -m splatformer_tpu_torch.train \
    --dataset oodbench_scale --output_dir run --only_eval \
    --override train.total_steps=5000 \
    --override dataset.max_gs_num="$PAD" --override dataset.pad_to="$PAD" \
    > only_eval.log 2>&1)

python -m splatformer_tpu_torch.eval_sweep --run "$OUT/run" \
    --dataset oodbench_scale --pad "$PAD" --csv "$OUT/eval_sweep.csv" \
    > "$OUT/sweep.log" 2>&1
tokens
echo "merge study complete: $OUT/eval_sweep.csv"
