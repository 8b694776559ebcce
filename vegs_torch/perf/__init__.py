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
  against QUALITY_TP_r02-r05 in QUALITY_TORCH_TP.md;
- `tiles`: the tile-shape sweep at 500k Gaussians (perf/r05_tiles.py);
- `stages`: the stage split and bisect at 500k (perf/stages_r02.py) and
  the backward bisect (perf/r03_bwd_bisect.py);
- `binning_probes`: the binning and row-gather A/Bs (perf/r06_binning.py,
  r08_binning2.py, r11_recscan.py);
- `satcull_analysis`: what a tile-saturation cull could prune at 2.23M,
  beside K4's and K1's prune (perf/r09_satcull_analysis.py);
- `quality_debug`: the arm-A debug trails at 64x128 and 128x256
  (perf/r12_quality_debug.py, r12b_grads.py);
- `micro`: the glue micro-probes at K = 2^21 (perf/micro_r02.py,
  micro2_r02.py, r03_micro.py, r03_micro2.py);
- `gebwd`: the gather backward's pieces, with K3 as the main path runs it
  and under the JAX contract (perf/r04_gebwd.py, r05_gebwd2.py,
  r05_segreduce.py, r05_segreduce2.py);
- `shard_check`: the tile-sharded render and the fully sharded trainer's
  step at D = 1 (perf/r07_shard_pallas.py);
- `quality` also holds the superseded r03, r04 and box_r04 quality runs
  (perf/quality_full.py, quality_full_r04.py, quality_box.py).

Each runs on the card, and fails without one, unless given device="cpu".
"""


def main_counters() -> dict:
    """The launch counters of the main paths' kernels: K1 and K2 (blend),
    K3 (the gather's backward), K4 (the sat count on the payload rows).
    Each is the wrapper whose `launches` counts its kernel's launches."""
    from ..ops import blend_cuda, satcull, segreduce

    return {"K1": blend_cuda.blend, "K2": blend_cuda.blend_bwd,
            "K3": segreduce.gather_expand_bwd, "K4": satcull.satcount_gathered}


def all_counters() -> dict:
    """`main_counters` and the layout probes' kernels M1 and M2."""
    from . import micro3

    return {**main_counters(), "M1": micro3.psum_consume,
            "M2": micro3.transpose}


def launch_counts(counters: dict) -> dict:
    """Each counter's launches so far."""
    return {k: c.launches for k, c in counters.items()}
