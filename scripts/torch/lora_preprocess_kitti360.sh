#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/lora_preprocess_kitti360.sh:
# the same flags and defaults, run through `python -m vegs_torch.*`.
# Runs on the host alone (image crops): no card needed.
set -euo pipefail
KITTI_ROOT=${KITTI_ROOT:-/data/KITTI-360}
SEQ=${SEQ:-2013_05_28_drive_0009_sync}
python -m vegs_torch.tools.lora_preprocess --kitti_root "$KITTI_ROOT" \
  --seq "$SEQ" --start_frame "$1" --end_frame "$2" \
  --out_dir "lora/data/kitti360/${SEQ}_${1}_${2}"
