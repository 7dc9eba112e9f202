#!/bin/bash
# The port's MCLMC tuner on the `complexity` study's members at widths 48,
# 32 and 16 (configs/ablations/complexity_bike_mclmc.yaml, bikesharing,
# FCN [W, W, W, 2], 12 chains, seed 1), exact float32 and at the TPU's one
# bfloat16 pass, side by side on one card: four lanes, widths 48 first,
# each run an experiments/torch_tune_members.py process.
#
#   experiments/torch_tune_widths.sh OUT MEMBERS_ROOT [STEPS]
#
# MEMBERS_ROOT holds the warm starts as bike_mclmc_WxWxW_r1/ (the
# run directories tests/test_torch_tuner_fullcount.py's
# complexity_members writes). STEPS defaults to the config's 50,000.
# Each run's JSON line goes to OUT/tune_wW_{exact,one_pass}.json, its
# error output to the same name with .log; OUT/card.txt holds the card's
# name and power limit and OUT/tune_wall.txt each lane's exit code and
# the wall time. DEVICE, when set, goes to each run's --device.
set -u
OUT=$1; MEMBERS=$2; STEPS=${3:-}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
T0=$(date +%s)
tune() {  # WIDTH ARITHMETIC
  local w=$1 arith=$2 flag=""
  [ "$arith" = one_pass ] && flag="--tpu-arithmetic"
  python3 experiments/torch_tune_members.py \
    --config configs/ablations/complexity_bike_mclmc.yaml \
    --members "$MEMBERS/bike_mclmc_${w}x${w}x${w}_r1" --set rng=1 \
    --set "model.hidden_structure=[$w, $w, $w, 2]" \
    ${STEPS:+--steps $STEPS} ${DEVICE:+--device $DEVICE} $flag \
    > "$OUT/tune_w${w}_${arith}.json" 2> "$OUT/tune_w${w}_${arith}.log"
}
pids=()
tune 48 exact & pids+=($!)
tune 48 one_pass & pids+=($!)
(tune 32 exact; tune 16 exact) & pids+=($!)
(tune 32 one_pass; tune 16 one_pass) & pids+=($!)
for p in "${pids[@]}"; do wait "$p"; echo "lane $p exit $?" >> "$OUT/tune_wall.txt"; done
echo "wall_s $(( $(date +%s) - T0 ))" >> "$OUT/tune_wall.txt"
