#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/normal_preprocess_kitti360.sh:
# the same flags and defaults, run through `python -m vegs_torch.*`.
# DPT normal maps for all sequences (reference bash_scripts/normal_preprocess_kitti360.sh)
# Needs a CUDA card: the DPT normal model runs on the card.
set -euo pipefail
KITTI_ROOT=${KITTI_ROOT:-/data/KITTI-360}
CKPT=${CKPT:-weights/omnidata_dpt_normal_v2.ckpt}
python -m vegs_torch.tools.estimate_normal --kitti_root "$KITTI_ROOT" \
  --checkpoint "$CKPT" --seqs "$@"
