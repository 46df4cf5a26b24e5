#!/usr/bin/env bash
# Auto-resuming training driver — failure recovery for long runs (device
# or host faults, OOM kills, preemption). Restarts
# multi_train with --resume 0 (restore latest checkpoint, or start fresh on
# an empty model dir) until it exits cleanly; each death costs at most the
# epochs since the last --checkpoint-every save.
#
# Usage: scripts/run_resumable.sh <multi_train args...>
#   Do not pass --resume (the driver owns it; rejected below).
#   MAX_RETRIES=20 (env) bounds restarts; the budget resets whenever an
#   attempt SAVED A NEW CHECKPOINT (real progress) — wall-clock survival
#   alone doesn't count, so a run that deterministically dies before its
#   first save can't loop from scratch forever.
set -u
max=${MAX_RETRIES:-20}
tries=0

model_dir="model"
prev=""
for a in "$@"; do
  if [ "$prev" = "--model-dir" ]; then model_dir="$a"; fi
  if [[ "$a" == --model-dir=* ]]; then model_dir="${a#--model-dir=}"; fi
  if [ "$a" = "--resume" ] || [[ "$a" == --resume=* ]]; then
    echo "run_resumable: do not pass --resume; the driver manages it" >&2
    exit 2
  fi
  prev="$a"
done

probe() {
  # gate each attempt on a bounded device probe so an unreachable device
  # parks us here instead of wedging a training process
  timeout "${PROBE_TIMEOUT_S:-180}" python -c \
    "import jax; jax.devices()" >/dev/null 2>&1
}

progress_mtime() {
  # newest mtime in the model dir — checkpoint saves bump it, so set
  # WATCHDOG_S comfortably above compile time + checkpoint-every interval
  find "$model_dir" -type f -printf '%T@\n' 2>/dev/null | sort -rn | head -1
}

while true; do
  until probe; do
    echo "run_resumable: device backend unreachable; re-probing in 60s" >&2
    sleep 60
  done
  stamp=$(mktemp)
  # Run the trainer in the background with a PROGRESS WATCHDOG: a process
  # can wedge without erroring. If neither the model dir nor the process exits within
  # WATCHDOG_S of the last progress, SIGKILL it and let the retry loop
  # restore the latest checkpoint.
  python -m dspnet_tpu.cli.multi_train "$@" --resume 0 &
  train_pid=$!
  wd=${WATCHDOG_S:-1800}
  start_ts=$(date +%s)
  while kill -0 "$train_pid" 2>/dev/null; do
    sleep 30
    last=$(progress_mtime)
    now=$(date +%s)
    ref=${last%%.*}
    [ -z "$ref" ] && ref=$start_ts
    [ "$ref" -lt "$start_ts" ] && ref=$start_ts
    if [ $((now - ref)) -gt "$wd" ]; then
      echo "run_resumable: no progress for ${wd}s; killing wedged trainer $train_pid" >&2
      kill -9 "$train_pid" 2>/dev/null
      break
    fi
  done
  wait "$train_pid"
  rc=$?
  [ "$rc" -eq 0 ] && { rm -f "$stamp"; exit 0; }
  if [ "$rc" -eq 3 ]; then
    # exit 3 = TrainingDiverged (NaN/inf loss): deterministic — a resume
    # replays the same seeded epoch and diverges again. Don't retry.
    echo "run_resumable: training diverged (exit 3); not retrying" >&2
    rm -f "$stamp"; exit 3
  fi
  progressed=$(find "$model_dir" -type f -newer "$stamp" 2>/dev/null | head -1)
  rm -f "$stamp"
  if [ -n "$progressed" ]; then tries=0; else tries=$((tries + 1)); fi
  if [ "$tries" -ge "$max" ]; then
    echo "run_resumable: giving up after $max attempts without a new checkpoint" >&2
    exit 1
  fi
  echo "run_resumable: train exited nonzero; retry $tries/$max in 30s" >&2
  sleep 30
done
