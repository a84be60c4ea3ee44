#!/usr/bin/env bash
# REAL275 accuracy parity through genpose_tpu_torch: the twin of
# tools/real275_parity_runbook.sh, driving the PyTorch port instead of the
# JAX package.  Needs no JAX.
#
# With the released GenPose artifacts (the reference README's "Download
# dataset and models" folder) laid out as the reference expects, under the
# run directory (default: the repository root):
#
#   results/ckpts/ScoreNet/ckpt_genpose.pth
#   results/ckpts/EnergyNet/ckpt_genpose.pth
#   results/evaluation_results/segmentation_results_real_test.pkl
#
# run:  bash genpose_tpu_torch/tools/real275_parity_runbook.sh
#
# Stages: port both .pth checkpoints to the port's format
# (genpose_tpu_torch/tools/port_torch_ckpt.py, written under results/ckpts/)
# -> the port's single-frame evaluation at the released protocol (K=50, the
# adaptive PF-ODE, T0=0.55, energy_ranker, average pooling, keep ratio 0.6:
# scripts/eval_single.sh) off the segmentation pkl, on the card -> the
# mean-class mAP row against the paper's.  The paper row
# (52.1/60.9/72.4/84.0 at 5d2cm/5d5cm/10d2cm/10d5cm, arXiv:2306.10531) is
# recalled, not read from the repository: verify it against the paper.
#
# Every path and the comparison can be overridden through the environment
# (a test runs this on a synthetic tree with a checkpoint it writes):
#   RUN_DIR      directory holding results/ (default: the repository root)
#   SCORE_PTH, ENERGY_PTH, SEG_PKL   the artifacts, relative to RUN_DIR
#   NOCS_DATASET_PATH                the evaluation's --data_path (default results)
#   DEVICE       cuda (default) or cpu
#   EVAL_REPEAT (50), BATCH_SIZE (256), SAMPLER (ode_adaptive), T0 (0.55)
#   EVAL_FLAGS   further flags for the evaluation (e.g. --num_points 128)
#   PORT_FLAGS   further flags for the porter (e.g. --num_points 128)
#   PAPER_ROW    the row to compare with, as JSON {"5d2cm": .., "5d5cm": .., ...}
#   PARITY_TOL   the 5-degree tolerance in points (default 0.5)
set -euo pipefail
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
cd "${RUN_DIR:-$REPO}"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

SCORE_PTH="${SCORE_PTH:-results/ckpts/ScoreNet/ckpt_genpose.pth}"
ENERGY_PTH="${ENERGY_PTH:-results/ckpts/EnergyNet/ckpt_genpose.pth}"
SEG_PKL="${SEG_PKL:-results/evaluation_results/segmentation_results_real_test.pkl}"
EVAL_REPEAT="${EVAL_REPEAT:-50}"
EVAL_FLAGS="${EVAL_FLAGS:-}"
PORT_FLAGS="${PORT_FLAGS:-}"

missing=0
for f in "$SCORE_PTH" "$ENERGY_PTH" "$SEG_PKL"; do
  if [ ! -f "$f" ]; then echo "MISSING: $f"; missing=1; fi
done
if [ "$missing" = 1 ]; then
  cat <<'EOF'

Artifacts absent.  Fetch the released checkpoints and the preprocessed
REAL275 test data per the reference repository's README ("Download dataset
and models"), lay them out as above, and run again.
EOF
  exit 2
fi

echo "=== stage 1/3: port the torch checkpoints ==="
# evaluation_single looks for --{score,energy}_model_dir under results/ckpts/
# shellcheck disable=SC2086
python -m genpose_tpu_torch.tools.port_torch_ckpt --input "$SCORE_PTH" \
  --output results/ckpts/ScoreNet/ckpt_genpose_ported --posenet_mode score $PORT_FLAGS
# shellcheck disable=SC2086
python -m genpose_tpu_torch.tools.port_torch_ckpt --input "$ENERGY_PTH" \
  --output results/ckpts/EnergyNet/ckpt_genpose_ported --posenet_mode energy $PORT_FLAGS

echo "=== stage 2/3: single-frame evaluation (released protocol) ==="
# --result_dir results: the runner finds the segmentation pkl under
# results/evaluation_results/ and loads it instead of running stage 1.
# shellcheck disable=SC2086
python -m genpose_tpu_torch.runners.evaluation_single \
  --score_model_dir ScoreNet/ckpt_genpose_ported \
  --energy_model_dir EnergyNet/ckpt_genpose_ported \
  --data_path "${NOCS_DATASET_PATH:-results}" \
  --sampler_mode "${SAMPLER:-ode_adaptive}" \
  --max_eval_num 1000000 \
  --batch_size "${BATCH_SIZE:-256}" \
  --seed 0 \
  --test_source real_test \
  --result_dir results \
  --eval_repeat_num "$EVAL_REPEAT" \
  --pooling_mode average \
  --ranker energy_ranker \
  --T0 "${T0:-0.55}" \
  --device "${DEVICE:-cuda}" \
  $EVAL_FLAGS

echo "=== stage 3/3: against the paper's row ==="
python - "results/evaluation_results/real_test_repeat_${EVAL_REPEAT}/mAP_headline.json" <<'EOF'
import json, os, sys
ours = json.load(open(sys.argv[1]))  # percent, mean class (written by the runner)
paper = json.loads(os.environ.get("PAPER_ROW") or
                   '{"5d2cm": 52.1, "5d5cm": 60.9, "10d2cm": 72.4, "10d5cm": 84.0}')
tol = float(os.environ.get("PARITY_TOL", "0.5"))
print(f"{'metric':>8} {'ours':>7} {'paper':>7} {'delta':>7}")
worst = 0.0
for k, p in paper.items():
    delta = ours[k] - p
    if k in ("5d2cm", "5d5cm"):
        worst = max(worst, abs(delta))
    print(f"{k:>8} {ours[k]:7.1f} {p:7.1f} {delta:+7.1f}")
print("PARITY:", f"PASS (within {tol} pts at 5d2cm/5d5cm)" if worst <= tol
      else f"CHECK (worst 5-degree delta {worst:.1f} pts)")
EOF
