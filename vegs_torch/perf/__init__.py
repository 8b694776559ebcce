"""The port's measurement tools (counterparts of the JAX package's perf/
scripts that reach a Pallas kernel):

- `micro3`: the layout probes of perf/micro3_r02.py, with kernels M1 (a
  float32 block sum, `csrc/blocksum.cu`) and M2 (a [K, C] -> [C, K]
  transpose, `csrc/transpose.cu`);
- `refscale`: the rasterizer's step split into stages at the reference's
  2,233,571 Gaussians (perf/r09_refscale.py);
- `roofline`: each stage's bound on the card beside its measured time
  (perf/r10_roofline.py);
- `timing`: CUDA-event timing and the card's name and power limit;
- `quality`: the end-to-end quality runs on the ray-traced oracle
  (perf/quality_full*.py, quality_r02.py, quality_box_r05.py), held
  against the JAX package's recorded readings in QUALITY_TORCH.md;
- `quality_tp`: the fully sharded trainer's quality runs against the
  single-device step at D spawned ranks (perf/quality_tp*.py), held
  against QUALITY_TP_r02-r05 in QUALITY_TORCH_TP.md.

Each runs on the card, and fails without one, unless given device="cpu".
"""
