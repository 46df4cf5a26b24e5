#!/usr/bin/env bash
# Full-scale dress rehearsal (VERDICT r4 item 2): train resnet-50_multi at
# the real Cityscapes scale (2975 train / 500 val synthetic images at raw
# 1024x2048, packed .drec — scripts/make_scale_dataset.py), through
# run_resumable.sh with a deliberate mid-run SIGKILL to prove resume, an
# RSS/wall sampler for host-memory leak detection,
# per-N-epoch 500-image evals, and a final --instance-eval measurement.
# Results are summarized in docs/SCALE_RUN.md.
#
# Usage: scripts/scale_run.sh [data_root] [model_dir] [end_epoch]
set -u
ROOT=${1:-/tmp/dspnet_scale}
MD=${2:-/tmp/scale_model}
EPOCHS=${3:-40}
LOG=${SCALE_LOG:-/tmp/scale_run}
mkdir -p "$LOG"

[ -f "$ROOT/train.drec" ] || python scripts/make_scale_dataset.py "$ROOT"

# RSS sampler: one line per 20 s for every multi_train process
(
  while true; do
    ts=$(date +%s)
    ps -eo pid,rss,etimes,args | grep "[m]ulti_train" | while read -r pid rss et _; do
      echo "{\"ts\": $ts, \"pid\": $pid, \"rss_mb\": $((rss / 1024)), \"etimes\": $et}"
    done
    sleep 20
  done
) >> "$LOG/rss.jsonl" &
SAMPLER=$!
trap 'kill $SAMPLER 2>/dev/null' EXIT

# kill-test: SIGKILL the trainer once, ~10 min in (after >=1 checkpoint at
# --checkpoint-every 4) — run_resumable must restore and continue
(
  sleep "${KILL_AFTER_S:-600}"
  pid=$(ps -eo pid,args | grep "[m]ulti_train" | awk '{print $2==""?$1:$1}' | head -1)
  if [ -n "$pid" ]; then
    echo "scale_run: kill-test SIGKILL pid $pid at $(date +%s)" >> "$LOG/events.log"
    kill -9 "$pid"
  fi
) &

t0=$(date +%s)
# --seg-normalize valid: the reference's unnormalized per-pixel-SUM seg
# loss is calibrated to lr 5e-4 and diverges at this run's lr 0.002 (the
# TrainingDiverged guard caught exactly that on the first attempt)
MAX_RETRIES=20 scripts/run_resumable.sh \
  --network resnet-50_multi --data-shape 3,512,1024 --num-classes 8 \
  --batch-size 8 --compute-dtype bfloat16 --lr 0.002 --seg-normalize valid \
  --dataset-root "$ROOT" --model-dir "$MD" \
  --loader native --native-u8 --loader-threads 8 \
  --end-epoch "$EPOCHS" --eval-every 8 --checkpoint-every 4 \
  --lr-steps "$((EPOCHS * 6 / 10)),$((EPOCHS * 85 / 100))" \
  --metrics-jsonl "$LOG/metrics.jsonl" 2>&1 | tee -a "$LOG/train.log" | \
  grep --line-buffered -E "epoch .* (done|validation)|resumable|input-s2d|native"
rc=${PIPESTATUS[0]}
echo "scale_run: train wall $(($(date +%s) - t0)) s (rc=$rc)" | tee -a "$LOG/events.log"
if [ "$rc" -ne 0 ]; then
  echo "scale_run: training failed (rc=$rc); skipping evals" | tee -a "$LOG/events.log"
  exit "$rc"
fi

# final eval: plain + instance-level (item 6 re-measurement), both timed
for extra in "" "--instance-eval"; do
  echo "scale_run: multi_eval $extra" | tee -a "$LOG/events.log"
  python -m dspnet_tpu.cli.multi_eval \
    --network resnet-50_multi --data-shape 3,512,1024 --num-classes 8 \
    --batch-size 2 --model-dir "$MD" --dataset-root "$ROOT" \
    --loader native --native-u8 --pipeline-depth 4 $extra \
    2>&1 | tee -a "$LOG/eval$extra.log" | grep -E "mAP|mIoU|accuracy|derror|ms_per_batch|instAP"
done
