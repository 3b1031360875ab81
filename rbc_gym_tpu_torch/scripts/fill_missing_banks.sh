#!/bin/bash
# Generate any missing checkpoint banks on the port (twin of
# scripts/fill_missing_banks.sh; idempotent: a bank present as .h5 or .npz
# is skipped). Covers the 3D rungs (Ra 2500, and 500, 1000, 8000, 16000
# for the controllability map) and the 2D ladder above Ra=1e4, with the
# launchers' seeds and episode counts, burned in on DEVICE.
# Environment:
#   OUT_DIR      banks live in OUT_DIR/{train,test,val}/ (default
#                chiprun_out/banks, which git ignores)
#   RAS_3D       the 3D rungs (default 2500 500 1000 8000 16000; empty: none)
#   RAS_2D       the 2D rungs (default 30000 ... 10000000; empty: none)
#   DURATION_3D  burn-in free-fall units (default 200)
#   DURATION_2D  burn-in time units (default 600)
#   DEVICE, FORMAT, PYTHON  as in create_checkpoints_2D.sh
# Extra arguments go to every generating call.
set -euo pipefail
cd "$(dirname "$0")/../.."

OUT_DIR="${OUT_DIR:-chiprun_out/banks}"
RAS_3D=(${RAS_3D-2500 500 1000 8000 16000})
RAS_2D=(${RAS_2D-30000 100000 300000 1000000 3000000 10000000})
DEVICE="${DEVICE:-cuda}"
FORMAT="${FORMAT:-npz}"
PYTHON="${PYTHON:-python}"
EXTRA=("$@")

present() { # path without suffix: true (and says so) if a bank is there
  local f
  for f in "$1.h5" "$1.npz"; do
    if [ -f "$f" ]; then
      echo "skip $f"
      return 0
    fi
  done
  return 1
}

gen2d() { # ra dir seed inits
  present "$OUT_DIR/$2/ckpt_ra$1" && return
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 2d --dir "$OUT_DIR/$2" \
    --seed "$3" --random_inits "$4" --Ra "$1" --duration "${DURATION_2D:-600}" \
    --delta_t 0.03 --device "$DEVICE" --format "$FORMAT" "${EXTRA[@]}"
}

gen3d() { # ra dir seed inits
  present "$OUT_DIR/$2/3D_ckpt_ra$1" && return
  "$PYTHON" -m rbc_gym_tpu_torch.experiments.create_checkpoints 3d --dir "$OUT_DIR/$2" \
    --seed "$3" --random_inits "$4" --Ra "$1" --duration "${DURATION_3D:-200}" \
    --device "$DEVICE" --format "$FORMAT" "${EXTRA[@]}"
}

for RA in "${RAS_3D[@]}"; do
  gen3d "$RA" train 42 20
  gen3d "$RA" test 62 10
  gen3d "$RA" val 72 10
done

for RA in "${RAS_2D[@]}"; do
  gen2d "$RA" train 42 20
  gen2d "$RA" test 62 10
  gen2d "$RA" val 72 10
done
echo "all banks present"
