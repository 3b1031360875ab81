#!/bin/bash
# Flow-statistics sweep on the port (twin of scripts/run_flowstats.sh).
# Runs the 3D Nu(Ra) / max-velocity sweep one process per Ra, so that a
# crash loses at most one Ra (the sweep rewrites its pickle after every
# Ra), then fits the power-law and Hill constants. Writes the port's own
# records, flowstats_ra_torch.{pkl,json} and flowstats_fits_torch.json, into
# OUT_DIR (default: beside the twins). Extra arguments go to every sweep
# process, e.g. a small grid on the CPU:
#   DEVICE=cpu RAS="500 750" STEPS=2 rbc_gym_tpu_torch/scripts/run_flowstats.sh \
#       --state_shape 8 8 8 --dt_solver 0.01 --heater_duration 0.0125
set -euo pipefail
cd "$(dirname "$0")/../.."

STEPS="${STEPS:-300}"
NUM_ENVS="${NUM_ENVS:-1}"
DEVICE="${DEVICE:-cuda}"
OUT_DIR="${OUT_DIR:-rbc_gym_tpu_torch/experiments/flowstats}"
RAS=(${RAS:-500 750 1000 1500 2000 4000 8000 16000 32000
     64000 128000 256000 512000 1000000})
PYTHON="${PYTHON:-python}"

mkdir -p "$OUT_DIR"
for RA in "${RAS[@]}"; do
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.flowstats.flowstats_ra \
    --ra "$RA" --steps "$STEPS" --num_envs "$NUM_ENVS" --device "$DEVICE" \
    --out "$OUT_DIR/flowstats_ra_torch.pkl" "$@"
done

"$PYTHON" -m rbc_gym_tpu_torch.experiments.flowstats.flowstats_fits \
  --pkl "$OUT_DIR/flowstats_ra_torch.pkl" --out "$OUT_DIR/flowstats_fits_torch.json"
