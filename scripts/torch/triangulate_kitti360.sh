#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/triangulate_kitti360.sh:
# the same flags and defaults, run through `python -m vegs_torch.*`.
# Runs on the host alone (COLMAP): no card needed.
set -euo pipefail
KITTI_ROOT=${KITTI_ROOT:-/data/KITTI-360}
SEQ=${SEQ:-2013_05_28_drive_0009_sync}
python -m vegs_torch.tools.triangulate --kitti_root "$KITTI_ROOT" \
  --seq "$SEQ" --start_frame "$1" --end_frame "$2"
