#!/bin/bash
# Generate 3D initial-condition banks on the port (twin of
# scripts/create_checkpoints_3D.sh: Ra=2500, N=32x32x16, 200 free-fall-unit
# burn-in; seeds 42/62/72, 20/10/10 episodes), burned in on DEVICE (K3 and
# K4 on the card).
# Environment:
#   OUT_DIR   banks go to OUT_DIR/{train,test,val}/3D_ckpt_ra<Ra>.<FORMAT>
#             (default chiprun_out/banks, which git ignores; the repo's
#             data/checkpoints holds the reference's banks)
#   RAS       the Ra values (default 2500)
#   DURATION  burn-in free-fall units (default 200)
#   DEVICE    cuda (default) or cpu
#   FORMAT    npz (default; the card has no h5py) or h5
#   PYTHON    the interpreter (default python)
# Extra arguments go to every call, e.g. a small grid on the CPU:
#   DEVICE=cpu DURATION=0.125 rbc_gym_tpu_torch/scripts/create_checkpoints_3D.sh \
#       --N 8 8 8 --random_inits 2
set -euo pipefail
cd "$(dirname "$0")/../.."

OUT_DIR="${OUT_DIR:-chiprun_out/banks}"
RAS=(${RAS:-2500})
DURATION="${DURATION:-200}"
DEVICE="${DEVICE:-cuda}"
FORMAT="${FORMAT:-npz}"
PYTHON="${PYTHON:-python}"

for RA in "${RAS[@]}"; do
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 3d --dir "$OUT_DIR/train" \
    --seed 42 --random_inits 20 --Ra "$RA" --duration "$DURATION" \
    --device "$DEVICE" --format "$FORMAT" "$@"
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 3d --dir "$OUT_DIR/test" \
    --seed 62 --random_inits 10 --Ra "$RA" --duration "$DURATION" \
    --device "$DEVICE" --format "$FORMAT" "$@"
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 3d --dir "$OUT_DIR/val" \
    --seed 72 --random_inits 10 --Ra "$RA" --duration "$DURATION" \
    --device "$DEVICE" --format "$FORMAT" "$@"
done
