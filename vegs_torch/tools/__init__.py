"""Offline tools around a training run (port of vegs_tpu/tools): monocular
normal estimation, LoRA data preparation and fine-tuning, known-pose COLMAP
triangulation."""
