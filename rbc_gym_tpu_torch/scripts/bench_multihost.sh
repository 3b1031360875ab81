#!/bin/bash
# Weak-scaling harness of the env-axis split, the twin of
# scripts/bench_multihost.sh: the one-process baseline, then two ranks
# (torchrun, a free local port) with the SAME envs per rank, then the
# parallel efficiency value(2 ranks) / (2 * value(1 rank)) as one JSON line.
#
# Arguments after the first two go to every bench_multihost.py call, e.g.
# `--device cpu --state_shape 16 32` on a host without a card, or
# `--backend gloo` for two ranks that share one card (which measures the
# split, not scaling: the ranks take turns on the one device).
#
# Usage: bash rbc_gym_tpu_torch/scripts/bench_multihost.sh [envs_per_process] [steps] [args...]
# Env: BENCH_MULTIHOST_OUT (default chiprun_out/bench_multihost, git-ignored), PYTHON.
set -euo pipefail
cd "$(dirname "$0")/../.."

ENVS=${1:-64}
STEPS=${2:-5}
shift $(( $# < 2 ? $# : 2 ))
PYTHON=${PYTHON:-python}
OUT=${BENCH_MULTIHOST_OUT:-chiprun_out/bench_multihost}
mkdir -p "$OUT"

echo "=== 1-process baseline (${ENVS} envs)" >&2
"$PYTHON" -m rbc_gym_tpu_torch.scripts.bench_multihost \
  --num_envs_per_process "$ENVS" --steps "$STEPS" --out "$OUT/p1.json" "$@"

echo "=== 2-rank weak scaling (${ENVS} envs/rank)" >&2
"$PYTHON" -m torch.distributed.run --standalone --nproc_per_node 2 \
  -m rbc_gym_tpu_torch.scripts.bench_multihost \
  --num_envs_per_process "$ENVS" --steps "$STEPS" --out "$OUT/p2.json" "$@"

"$PYTHON" - "$OUT" <<'PY'
import json, sys
out = sys.argv[1]
p1 = json.load(open(f"{out}/p1.json"))
p2 = json.load(open(f"{out}/p2.json"))
eff = p2["value"] / (p2["processes"] * p1["value"])
print(json.dumps({
    "metric": "multihost_weak_scaling_efficiency_2d",
    "value": eff,
    "unit": "fraction",
    "baseline_env_steps_per_sec": p1["value"],
    "scaled_env_steps_per_sec": p2["value"],
    "processes": p2["processes"],
    "envs_per_process": p2["envs_per_process"],
    "device": p2["device"],
    "backend": p2["backend"],
}))
PY
