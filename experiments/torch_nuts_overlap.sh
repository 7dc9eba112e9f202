#!/bin/bash
# The graphed NUTS leaf on one card at a given tree depth: each job's
# leaf alone, then two processes of the same job's leaf side by side,
# then a cut warm start (host-bound) alone and beside one NUTS loop.
#
#   experiments/torch_nuts_overlap.sh OUT DEPTH JOBS WS_JOB WS_EPOCHS
#       [STEPS_ALONE (5)] [STEPS_PAIR (15)] [STEPS_BESIDE (40)]
#
# JOBS is a comma-separated list of catalogue jobs whose shapes are timed
# (experiments/torch_nuts_leaf_rate.py --graph-only); the NUTS loop beside
# the warm start is the first of them. OUT receives the card's name and
# power limit (card.txt) and one JSON line a process: alone.jsonl,
# pair_JOB_{a,b}.jsonl, ws_alone.jsonl, ws_beside.jsonl and
# nuts_beside.jsonl (each line with its `ended_at` time). DEVICE, when
# set, goes to every process's --device.
set -u
OUT=$1; DEPTH=$2; JOBS=$3; WS=$4; EPOCHS=$5
ALONE=${6:-5}; PAIR=${7:-15}; BESIDE=${8:-40}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  > "$OUT/card.txt" 2>/dev/null
leaf() { python3 experiments/torch_nuts_leaf_rate.py --graph-only \
  --depth "$DEPTH" ${DEVICE:+--device $DEVICE} "$@"; }
warm() { python3 experiments/torch_nuts_leaf_rate.py --jobs "$WS" \
  --warmstart-epochs "$EPOCHS" ${DEVICE:+--device $DEVICE}; }
leaf --jobs "$JOBS" --steps "$ALONE" > "$OUT/alone.jsonl"
for job in ${JOBS//,/ }; do
  leaf --jobs "$job" --steps "$PAIR" > "$OUT/pair_${job}_a.jsonl" &
  a=$!
  leaf --jobs "$job" --steps "$PAIR" > "$OUT/pair_${job}_b.jsonl" &
  wait "$a" "$!"
done
warm > "$OUT/ws_alone.jsonl"
echo "{\"started_at\": $(date +%s.%N)}" > "$OUT/beside_start.json"
leaf --jobs "${JOBS%%,*}" --steps "$BESIDE" > "$OUT/nuts_beside.jsonl" &
n=$!
warm > "$OUT/ws_beside.jsonl"
wait "$n"
