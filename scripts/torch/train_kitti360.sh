#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/train_kitti360.sh:
# the same flags and defaults, run through `python -m vegs_torch.*`.
# Train one KITTI-360 segment (parity with the reference's
# bash_scripts/train_kitti360.sh; the device is the card).
# Needs a CUDA card: `python -m vegs_torch.train` takes no device flag and
# trains on the card (vegs_torch.train.main(argv, device="cpu") runs on
# the CPU).
set -euo pipefail
KITTI_ROOT=${KITTI_ROOT:-/data/KITTI-360}
SEQ=${SEQ:-2013_05_28_drive_0009_sync}
START=${START:-3972}
END=${END:-4258}
OUT=${OUT:-output/kitti360_${SEQ}_${START}_${END}}

python -m vegs_torch.train \
  --source_path "$KITTI_ROOT" --model_path "$OUT" \
  --seq "$SEQ" --start_frame "$START" --end_frame "$END" \
  --data_type kitti360 --eval "$@"
