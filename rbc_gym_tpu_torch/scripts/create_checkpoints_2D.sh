#!/bin/bash
# Generate 2D initial-condition banks on the port (twin of
# scripts/create_checkpoints_2D.sh): train/test/val splits across the
# reference's Ra ladder (seeds 42/62/72, 20/10/10 episodes, 600 time-unit
# burn-in, dt=0.03), burned in on DEVICE (K1 on the card).
# Environment:
#   OUT_DIR   banks go to OUT_DIR/{train,test,val}/ckpt_ra<Ra>.<FORMAT>
#             (default chiprun_out/banks, which git ignores; the repo's
#             data/checkpoints holds the reference's banks)
#   RAS       the Ra ladder (default 1e4 ... 1e7)
#   DURATION  burn-in time units (default 600)
#   DEVICE    cuda (default) or cpu
#   FORMAT    npz (default; the card has no h5py) or h5
#   PYTHON    the interpreter (default python)
# Extra arguments go to every call, e.g. a small grid on the CPU:
#   DEVICE=cpu RAS=10000 DURATION=0.3 rbc_gym_tpu_torch/scripts/create_checkpoints_2D.sh \
#       --N 32 16 --random_inits 2
set -euo pipefail
cd "$(dirname "$0")/../.."

OUT_DIR="${OUT_DIR:-chiprun_out/banks}"
RAS=(${RAS:-10000 30000 100000 300000 1000000 3000000 10000000})
DURATION="${DURATION:-600}"
DEVICE="${DEVICE:-cuda}"
FORMAT="${FORMAT:-npz}"
PYTHON="${PYTHON:-python}"

for RA in "${RAS[@]}"; do
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 2d --dir "$OUT_DIR/train" \
    --seed 42 --random_inits 20 --Ra "$RA" --duration "$DURATION" --delta_t 0.03 \
    --device "$DEVICE" --format "$FORMAT" "$@"
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 2d --dir "$OUT_DIR/test" \
    --seed 62 --random_inits 10 --Ra "$RA" --duration "$DURATION" --delta_t 0.03 \
    --device "$DEVICE" --format "$FORMAT" "$@"
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 2d --dir "$OUT_DIR/val" \
    --seed 72 --random_inits 10 --Ra "$RA" --duration "$DURATION" --delta_t 0.03 \
    --device "$DEVICE" --format "$FORMAT" "$@"
done
