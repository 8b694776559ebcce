#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/lora_train_kitti360.sh:
# the same flags and defaults, run through `python -m vegs_torch.*`.
# Per-segment LoRA training (parity with reference bash_scripts/
# lora_train_kitti360.sh + the segment loop in
# lora/scripts/train_text_to_image_lora_kitti360.py:846-864).
#
# Usage: scripts/torch/lora_train_kitti360.sh <sd_checkpoint_dir> [segments_file]
# Needs a CUDA card: the LoRA fine-tuning runs on the card.
set -euo pipefail
CKPT=${1:?usage: $0 <sd_checkpoint_dir> [segments_file]}
SEGMENTS=${2:-lora/data/kitti360/2013_05_28_drive_train_dynamic_vehicle_human_track_num_vehicles.txt}
SEED=1337

python -m vegs_torch.tools.lora_train \
  --checkpoint_dir "$CKPT" \
  --data_root lora/data/kitti360 \
  --out_dir lora/models/kitti360 \
  --segments_file "$SEGMENTS" \
  --steps 300 --batch_size 1 --grad_accum 4 \
  --learning_rate 1e-4 --seed $SEED
