#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/render_video.sh:
# the same flags and defaults, run through `python -m vegs_torch.*`.
# Needs a CUDA card: the videos render on the card (render_video.main
# takes no device flag).
set -euo pipefail
OUT=${OUT:?set OUT to the trained model path}
python -m vegs_torch.render_video --model_path "$OUT" "$@"
