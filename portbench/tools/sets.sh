#!/usr/bin/env bash
# Two sets of runs of one cell over the same seeds (set A, then set B), each
# run a fresh process, as the bounds in BENCHMARK.json are measured:
#   bash portbench/tools/sets.sh <workload> <seconds> <out dir> <seed>...
# Each run's output goes to <out dir>/<workload>.<set>.<seed>.out (.err);
# portbench/tools/spread.py reads them.
wl=$1; secs=$2; out=$3; shift 3
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
for set in A B; do
  for seed in "$@"; do
    s0=$SECONDS
    python3 portbench/run.py --workload "$wl" --seed "$seed" --seconds "$secs" --trace 0 \
      > "$out/$wl.$set.$seed.out" 2> "$out/$wl.$set.$seed.err"
    echo "$set $seed rc=$? $((SECONDS - s0))s $(tail -1 "$out/$wl.$set.$seed.out" | cut -c1-300)"
  done
done
