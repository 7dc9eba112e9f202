#!/bin/bash
# Jobs of the port's study catalogue side by side on one card: one
# experiments/torch_catalog_queue.py loop per SPEC, all started together
# (each job is host-bound, so several share the card), then each
# (root, study) pooled by pool_results.py and compared with the JAX
# package's pooled study by torch_compare_study.py.
#
#   experiments/torch_study_side_by_side.sh OUT LIMIT_S SPEC [SPEC ...]
#     SPEC = ROOT:STUDY:REGEX[:STUDY:REGEX ...][:nosplit][:tpu]
#       (each STUDY:REGEX one --stage of the loop, run in turn; tpu: the
#       loop's --tpu-arithmetic; nosplit: its --no-split-k, the NUTS
#       leaf's graph on the plain Dense product; a REGEX holds no colon)
#
# Each loop runs under `timeout LIMIT_S`. OUT receives the card's name
# and power limit (card.txt), nvidia-smi samples every 30 s (smi.csv),
# each loop's exit code and the wall time (loops.txt), and per root
# (named by its last component) aggr_STUDY.csv, compare_STUDY.csv, the
# comparison's table (compare_STUDY.txt), the root's queue.jsonl and
# queue_driver.log, and the run directories without their draws
# (samples.bin, samples.npy) and the warm start's per-step curves
# (warmstart/metrics.pkl, megabytes a job at protein's 1,001 batches an
# epoch); what pool_results.py reads and the warm-start members stay.
# DEVICE and RUNNER, when set, go to each loop's --device and --runner.
set -u
OUT=$1; LIMIT=$2; shift 2
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
nvidia-smi --query-gpu=timestamp,utilization.gpu,power.draw,clocks.sm,memory.used \
  --format=csv -l 30 > "$OUT/smi.csv" 2>&1 &
SMI=$!
T0=$(date +%s)
pids=()
# SPEC -> "ROOT STUDY REGEX STUDY REGEX ...", one word a field, with
# the loop's options of its trailing flags in `flags`
fields() {
  IFS=: read -r -a f <<< "$1"
  flags=()
  while [ "${#f[@]}" -gt 3 ]; do
    case ${f[-1]} in
      tpu) flags+=(--tpu-arithmetic) ;;
      nosplit) flags+=(--no-split-k) ;;
      *) break ;;
    esac
    unset 'f[-1]'
  done
}
for spec in "$@"; do
  fields "$spec"
  root=${f[0]}
  stages=()
  for ((i = 1; i + 1 < ${#f[@]}; i += 2)); do
    stages+=(--stage "${f[i]}:${f[i+1]}")
  done
  timeout -k 20 "$LIMIT" python3 experiments/torch_catalog_queue.py \
    --root "$root" "${stages[@]}" --aggr-dir "$root/aggr" \
    --cooloff 60 ${flags[@]+"${flags[@]}"} ${DEVICE:+--device $DEVICE} \
    ${RUNNER:+--runner "$RUNNER"} > /dev/null 2>&1 &
  pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; echo "loop $p exit $?" >> "$OUT/loops.txt"; done
echo "wall_s $(( $(date +%s) - T0 ))" >> "$OUT/loops.txt"
kill $SMI 2>/dev/null
for spec in "$@"; do
  fields "$spec"
  for ((i = 1; i + 1 < ${#f[@]}; i += 2)); do echo "${f[0]}:${f[i]}"; done
done | sort -u | while IFS=: read -r root study; do
  tag=$(basename "$root")
  mkdir -p "$OUT/$tag"
  python3 experiments/pool_results.py "$root/$study" \
    -o "$OUT/$tag/aggr_$study.csv" > /dev/null 2>&1
  python3 experiments/torch_compare_study.py "$study" \
    --port "$OUT/$tag/aggr_$study.csv" --out "$OUT/$tag/compare_$study.csv" \
    > "$OUT/$tag/compare_$study.txt" 2>&1
  cp "$root/queue.jsonl" "$OUT/$tag/queue_$study.jsonl" 2>/dev/null
  cp "$root/queue_driver.log" "$OUT/$tag/" 2>/dev/null
  (cd "$root" && tar cf - --exclude='samples.bin' --exclude='samples.npy' \
    --exclude='warmstart/metrics.pkl' "$study") \
    | (cd "$OUT/$tag" && tar xf -)
done
du -sh "$OUT"
