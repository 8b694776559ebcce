"""Smoke run of the PyTorch/CUDA port (vegs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one JSON line each; any failure exits non-zero:
  1. device   -- a CUDA card is present (prints nvidia-smi's name and power
                 limit);
  2. build    -- nvcc builds kernels K1 (blend forward), K2 (blend
                 backward), K3 (segment reduce) and K4 (saturation count)
                 from vegs_torch/csrc, in parallel; ptxas registers and
                 shared memory per kernel;
  3. k4_check -- K4 against its plain PyTorch version on a saturating
                 reduced scene (128x512, 60k Gaussians);
  4. k1_check -- K1 against its plain version at 128x512 with 30k Gaussians,
                 f32 and bf16 aux payloads;
  5. main     -- the serving path at full width: a seeded synthetic trained
                 field of 2,233,571 Gaussians (SH degree 3) written as a PLY,
                 loaded into a Scene with 3 street cameras at 376x1408,
                 capacities sized by a probe (no instance dropped), and
                 `render_frames` over the four default trajectories (12
                 frames) with the launch counters reset just before; then
                 the sat cull on vs off must give bit-identical rgb, depth
                 and alpha, and K1/K4 are held against their plain versions
                 on that frame's inputs;
  6. timing   -- ms per frame, K1/K4 ms at the full-width shapes (CUDA
                 events), the plain versions' ms, the bound of each kernel,
                 peak device memory; then a profile of 4 frames;
  7. train    -- the training path at full width on the same field: ground
                 truth rendered from it on the 3 cameras, sh_dc perturbed by
                 +0.35, a synthetic unit normal map (normal loss on), and 8
                 steps of `Trainer.train_iteration` (iterations 3001-3008,
                 SH degree 3, bf16 aux, sat cull on, one densify-and-prune
                 event at the end of 3008), with the launch counters reset
                 just before; loss per step, ms per step, the densify step's
                 time, peak memory, launches (each kernel once per step),
                 then capacities re-probed for the densified field and a
                 profile of 2 more steps on it;
  8. k2/k3    -- K2 and K3 against their plain versions on the first
                 step's full-width inputs, with card, plain, bound and (K3)
                 library times;
  9. grad     -- one step's gradients (every field leaf and the means2d
                 tap) through the kernels on the card against the plain
                 versions on the CPU, on a reduced scene (128x512, 50k
                 Gaussians, bf16 aux);
 10. perf     -- the measurement path (`vegs_torch.perf`), after the train
                 phase's tensors are freed: M1 (block sum) and M2
                 (transpose) against their plain versions at the probes'
                 full size (K = 2^21, f32 [K, 8] and bf16 [K, 16]; M1 in
                 both layouts), with card, plain, library times and
                 bounds (m1_check, m2_check); then, with every launch
                 counter set to 0, the eight layout probes (micro3), the
                 stage split at 2,233,571 Gaussians, 376x1408, 16x16
                 tiles, sat cull on (refscale), and each stage's bound and
                 share of its time (roofline); every kernel must have
                 launched in this path;
 11. the kernels summary line, then the card line, then the last line
     {"ok": true, "device": {...}}.

Tolerances: K4 counts must agree (a tile may differ only by exactly one
256-slot window, and is reported; the bit-identical sat-cull render is the
binding check). K1 against its plain version: |d| <= 1e-5 + 1e-4 * |ref| on
every channel outside pixels whose stop index differs, and those at most
0.1% of the pixels -- the plain version prefix-sums log(1 - alpha) with a
parallel scan and accumulates the channels with a matmul, the kernel walks
each pixel sequentially with FMAs, so the sums differ in order only.

K2, K3 and the step gradients are each held by a limit set from the
readings of a sound run on an H100, and each check also reads a control --
a deliberately wrong result -- which must fall outside the limit (readings
and controls in PERF.md). K2, on the instances of tiles whose pixels all
stop where the plain forward stops (such flip tiles at most 1%): |d| <=
1e-4 of the largest |plain| of the f32 row, and of the aux row within the
instance's group (its tile's 256-instance batch), plus one bf16 ulp (2^-7
|ref|) on bf16 rows; control: the kernel's output 1% off on the instances
after each tile's first 256. K3: |d| <= 1e-5 * (sum of |x| over the
segment) -- the plain version adds with atomics in any order on the card;
control: each segment's last column left out. Step gradients: relative L2
error <= 1e-4 per leaf; control: K2's f32 rows rounded to bf16. M2 must be
bit-identical to its plain version. M1: |d| <= 1e-8 * (sum of |x|) -- the
kernel and its plain version add in other orders; the sound readings on an
H100 are at most 1.3e-10; control: the sum with the last 2^17-long block
left out.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
H, W = 376, 1408
N_REF = 2_233_571            # the reference's recorded scene size
SEED = 0
PROBE_CAP = (1 << 23) - 512  # raw capacity of the sizing probe

# Each kernel's bound (vegs_torch/perf/roofline.py): the larger of the
# bytes its inputs and outputs move once at 3.35 TB/s and the fp32
# operations these inputs need at 67 TFLOP/s, counted with the plain
# versions' `pairs` record of this run.

K1_ATOL, K1_RTOL, MAX_FLIP_SHARE = 1e-5, 1e-4, 1e-3
K2_RTOL = 1e-4
# the scale each K2 row set is held by (see `k2_readings`): the f32 rows'
# low-T instances cancel in f32 (dL = tail - cum), in the kernel and the
# plain version alike, so they are held by the row's max
K2_SCALE = {"f32_rows": "row", "aux_rows": "group"}
BF16_ULP, K2_MAX_FLIP_TILES = 2.0 ** -7, 0.01
K3_RTOL = 1e-5
GRAD_RTOL = 1e-4
CONTROL_ERR = 0.01  # the K2 control's error on the deep instances
M1_RTOL = 1e-8

# Iterations 3001-3008 (SH degree 3 active); the one densify-and-prune
# event falls at 3008, after that step's loss, so the losses compare the
# same field's training and the 2 profiled steps run on the densified field.
TRAIN_FIRST_IT, TRAIN_STEPS, DENSIFY_EVERY = 3001, 8, 8
TRAIN_CAMS = (0, 1, 2, 0, 1, 2, 1, 0)  # the last step sees the first's view


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def r512(v: float) -> int:
    return (int(v) + 511) // 512 * 512


def field_stage(field, cam, cfg):
    from vegs_torch.render import field_arrays
    from vegs_torch.ops.rasterize import stage

    a = field_arrays(field)
    return stage(a.means, a.quats, a.scales, a.opacities, a.shs, cam,
                 valid=a.valid, config=cfg)


def compare_k4(st):
    """K4 vs satcount_ref on the same CUDA inputs."""
    from vegs_torch.ops import satcull

    grid = st.grid
    k = satcull.satcount(st.pf_sorted, st.rb.raw_starts, grid)
    t0 = time.perf_counter()
    ref = satcull.satcount_ref(st.pf_sorted, st.rb.raw_starts, grid)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    d = (k.long() - ref.long()).abs()
    bad = int(((d != 0) & (d != 256)).sum())
    if bad:
        raise AssertionError(f"K4: {bad} tiles differ from the plain version "
                             "by other than one 256-slot window")
    raw = int(st.rb.raw_starts[-1] - st.rb.raw_starts[0])
    return {"tiles": grid.num_tiles, "tiles_off_by_256": int((d == 256).sum()),
            "max_abs_err": int(d.max()), "kept": int(k.sum()), "raw": raw,
            "plain_ms": plain_s * 1e3}


def compare_k1(st):
    """K1 vs blend_ref_tiles on the same CUDA inputs."""
    from vegs_torch.ops import blend_cuda

    grid = st.grid
    hp, wp = grid.padded_height, grid.padded_width
    args = (st.payload_f32, st.payload_aux, st.binned.tile_starts, grid, hp, wp)
    out, stop = blend_cuda.blend(*args, return_stop=True)
    t0 = time.perf_counter()
    ref, stop_ref = blend_cuda.blend_ref_tiles(*args, return_stop=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise AssertionError("K1 output is not finite")
    flips = stop != stop_ref
    d = (out - ref).abs()
    bad = (d > K1_ATOL + K1_RTOL * ref.abs()).any(dim=0) & ~flips
    n_flips = int(flips.sum())
    per_chan = d.masked_fill(flips[None], 0).amax(dim=(1, 2))
    res = {"pixels": hp * wp, "stop_flips": n_flips,
           "max_abs_err_per_channel": [float(x) for x in per_chan],
           "max_abs_err": float(per_chan.max()),
           "instances": int(st.binned.tile_starts[-1]),
           "plain_ms": plain_s * 1e3}
    if int(bad.sum()):
        raise AssertionError(f"K1: {int(bad.sum())} pixels outside tolerance "
                             f"without a stop flip: {res}")
    if n_flips > MAX_FLIP_SHARE * hp * wp:
        raise AssertionError(f"K1: {n_flips} stop-index flips: {res}")
    return res


KERNEL_GROUPS = (("K1 blend_fwd", ("blend_fwd_kernel",)),
                 ("K2 blend_bwd", ("blend_bwd_kernel",)),
                 ("K3 segreduce", ("segreduce_kernel",)),
                 ("K4 satcount", ("satcount_kernel",)),
                 ("conv (SSIM)", ("conv", "Conv", "cudnn", "implicit_gemm")),
                 ("sort", ("sort", "Sort", "radix", "Radix")),
                 ("scan", ("scan", "Scan", "cumsum", "cummax")),
                 ("gather/scatter", ("index", "Index", "gather", "scatter")),
                 ("copy", ("Memcpy", "memcpy", "Memset", "memset")))


def profile_frames(fn) -> dict:
    """Device time by kernel group and the device's busy share of the wall
    time of `fn` (torch.profiler's CUDA kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, groups, by_name = [], {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.name for k in keys)), "elementwise/other")
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (end - start) / 1e3
    busy, last = 0.0, None
    for start, end in sorted(spans):  # union of kernel intervals
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / wall_us) if spans else None,
            "kernels": len(spans), "ms_by_group": groups,
            "top_kernels_ms": dict(top)}


def slot_tiles(tile_starts, k, grid):
    """Per padded slot: its tile, and its 256-instance batch in the tile's
    range (slots past tile_starts[-1] fall in the last tile's tail)."""
    from vegs_torch.ops.binning import PAD_ALIGN

    ts = tile_starts.long()
    slot = torch.arange(k, device=ts.device)
    tile = torch.searchsorted(ts[1:], slot, right=True).clamp(
        max=grid.num_tiles - 1)
    return tile, (slot - ts[tile]) // PAD_ALIGN


def deep_control(tile_starts, k, grid):
    """[k] f32 factors of the control: 1 + CONTROL_ERR on every instance
    after its tile's first 256 (the deep, low-T instances), 1 elsewhere --
    an error a wrong kernel could make there and nowhere else."""
    _, batch = slot_tiles(tile_starts, k, grid)
    return 1.0 + CONTROL_ERR * (batch > 0).float()


def staged_loss(field, tap, cam, gt, normal, sh_degree, bg, opt_cfg,
                raster_cfg):
    """The training step's loss (`train.loss_fn`) from the stages that
    `rasterize` runs on the kernel path, called one by one -- `stage`, the
    blend (`BlendFn`: K1, and K2 in the backward), `raster_out`,
    `image_loss` -- so that the blend's payload and padded output are at
    hand. Returns (loss, Staged, padded output)."""
    from vegs_torch.ops.blend_cuda import BlendFn
    from vegs_torch.ops.rasterize import raster_out, stage
    from vegs_torch.render import field_arrays
    from vegs_torch.train import image_loss

    a = field_arrays(field, sh_degree)
    st = stage(a.means, a.quats, a.scales, a.opacities, a.shs, cam,
               sh_degree=3, valid=a.valid, means2d_offset=tap,
               config=raster_cfg)
    g = st.grid
    out_p = BlendFn.apply(st.payload_f32, st.payload_aux,
                          st.binned.tile_starts, g, g.padded_height,
                          g.padded_width)
    ro = raster_out(st, out_p[:, :cam.height, :cam.width], bg)
    return image_loss(ro, gt, normal, 1.0, opt_cfg)[0], st, out_p


def step_kernel_inputs(trainer, cam, it, dev):
    """K2's and K3's inputs of the step `trainer` would take next on `cam`:
    the same loss, its gradient at the blend's padded output (K2's dout),
    and K3's columns from K2's output on them (no Adam update). Returns
    (K2 args, K3 args, the loss)."""
    from vegs_torch.ops import blend_cuda
    from vegs_torch.ops.rasterize import cotangent_columns

    field = trainer.state.field
    tap = torch.zeros((field.capacity, 2), device=dev, requires_grad=True)
    gt = torch.from_numpy(np.asarray(cam.original_image, np.float32)).to(dev)
    normal = torch.from_numpy(np.asarray(cam.world_normal(), np.float32)
                              ).to(dev)
    loss, st, out_p = staged_loss(
        field, tap, cam.device_params(dev), gt, normal,
        trainer._active_sh_degree(it), trainer.bg, trainer.cfg.opt,
        trainer.raster_cfg)
    (dout,) = torch.autograd.grad(loss, out_p)
    k2_args = (st.payload_f32.detach(), st.payload_aux.detach(),
               st.binned.tile_starts, out_p.detach(), dout.contiguous(),
               st.grid)
    dpf, dpa = blend_cuda.blend_bwd(*k2_args)
    # the segment ends as `stage` gives them to the gather (the dummy row n
    # gets an empty segment)
    ends = torch.cat([st.binned.gauss_ends, st.binned.gauss_ends[-1:]])
    k3_args = cotangent_columns(dpf, dpa, st.binned.order, ends)
    torch.cuda.synchronize()
    return k2_args, k3_args, float(loss.detach())


def k2_readings(kern, ref, tile_starts, grid, keep, ulp):
    """The largest |kernel - plain| (less one bf16 ulp of the plain value on
    bf16 rows), on the slots in `keep` (tiles without a stop flip), over
    two scales of each gradient row: the row's largest |plain| ("row"), and
    the largest |plain| of the instance's group, the 256-instance batch of
    its tile in which it is staged ("group"; a group whose plain gradients
    are all zero reads inf unless the kernel's are zero too)."""
    tile, batch = slot_tiles(tile_starts, kern.shape[1], grid)
    group = torch.unique(tile * (batch.max() + 1) + batch,
                         return_inverse=True)[1]
    ng = int(group.max()) + 1
    d = ((kern - ref).abs() - ulp * ref.abs()).clamp(min=0)
    d = torch.where(keep[None, :], d, torch.zeros((), device=d.device))
    idx = group[None, :].expand(ref.shape[0], -1)
    gref = ref.new_zeros(ref.shape[0], ng).scatter_reduce_(
        1, idx, ref.abs(), "amax")
    gd = ref.new_zeros(ref.shape[0], ng).scatter_reduce_(1, idx, d, "amax")
    inf = torch.tensor(float("inf"), device=d.device)
    by_group = torch.where(gref > 0, gd / gref.clamp(min=1e-30),
                           torch.where(gd > 0, inf, torch.zeros_like(gd)))
    by_row = d.amax(dim=1) / ref.abs().amax(dim=1).clamp(min=1e-30)
    return {"row": float(by_row.max()), "group": float(by_group.max())}


def compare_k2(k2_args):
    """K2 vs blend_bwd_ref_tiles on the same CUDA inputs, outside the tiles
    where K1 and its plain version stop at different instances: the
    readings (`k2_readings`) of the sound kernel and of the control, the
    kernel's output off by CONTROL_ERR on the deep instances
    (`deep_control`)."""
    from vegs_torch.ops import blend_cuda

    pf, pa, ts, out, dout, grid = k2_args
    hp, wp = grid.padded_height, grid.padded_width
    _, stop = blend_cuda.blend(pf, pa, ts, grid, hp, wp, return_stop=True)
    pairs = {}
    _, stop_ref = blend_cuda.blend_ref_tiles(pf, pa, ts, grid, hp, wp,
                                             return_stop=True, pairs=pairs)
    kpf, kpa = blend_cuda.blend_bwd(*k2_args)
    t0 = time.perf_counter()
    rpf, rpa = blend_cuda.blend_bwd_ref_tiles(*k2_args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for x in (kpf, kpa, rpf, rpa):
        if not torch.isfinite(x).all():
            raise AssertionError("K2 or its plain version is not finite")
    flips = (stop != stop_ref).reshape(grid.nty, grid.tile_h, grid.ntx,
                                       grid.tile_w).any(dim=3).any(dim=1)
    tile, batch = slot_tiles(ts, pf.shape[1], grid)
    keep = ~flips.reshape(-1)[tile]
    ctl = deep_control(ts, pf.shape[1], grid)
    bf16_ulp = BF16_ULP if pa.dtype == torch.bfloat16 else 0.0
    res = {"tiles": grid.num_tiles, "flip_tiles": int(flips.sum()),
           "instances": int(ts[-1]),
           "deep_instances": int((batch > 0)[:int(ts[-1])].sum()),
           "nonzero_dop": int((kpf[5] != 0).sum()), "plain_ms": plain_s * 1e3,
           "pairs": pairs}
    for rows, k, r, ulp in (("f32_rows", kpf, rpf, 0.0),
                            ("aux_rows", kpa, rpa.float(), bf16_ulp)):
        k_ctl = (k.float() * ctl).to(k.dtype).float()
        res[rows] = {
            "reading": k2_readings(k.float(), r, ts, grid, keep, ulp),
            "control_reading": k2_readings(k_ctl, r, ts, grid, keep, ulp)}
    res["max_abs_err"] = float(max(
        (kpf - rpf)[:, keep].abs().max(),
        (kpa.float() - rpa.float())[:, keep].abs().max()))
    return res


def hold(name, reading, limit, control=None):
    """Fail unless the sound reading is within `limit` and the control
    reading (of a deliberately wrong result) is outside it."""
    if not reading <= limit:
        raise AssertionError(f"{name}: reading {reading} over the limit "
                             f"{limit}")
    if control is not None and not control > limit:
        raise AssertionError(f"{name}: the control reads {control}, within "
                             f"the limit {limit}: the check is too loose")


def compare_k3(k3_args):
    """K3 vs segment_reduce_ref (index_add_, atomics on the card) on the
    same CUDA inputs; the tolerance scales with each segment's |x| sum."""
    from vegs_torch.ops import segreduce

    cols, starts, ends = k3_args
    got = segreduce.segment_reduce_cols(cols, starts, ends)
    t0 = time.perf_counter()
    ref = segreduce.segment_reduce_ref(cols, starts, ends)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    mag = segreduce.segment_reduce_ref(cols.abs(), starts, ends)
    # the control: each nonempty segment's last column left out (an
    # off-by-one segment end)
    short = segreduce.segment_reduce_ref(
        cols, starts, torch.maximum(ends - 1, starts))
    d = (got - ref).abs()

    def reading(x):
        return float(((x - ref).abs() / mag.clamp(min=1e-30)).max())

    if not torch.isfinite(got).all():
        raise AssertionError("K3 output is not finite")
    return {"segments": int(starts.shape[0]), "columns": int(cols.shape[1]),
            "rows": int(cols.shape[0]), "summed": int(ends[-1] - starts[0]),
            "max_abs_err": float(d.max()), "reading": reading(got),
            "control_reading": reading(short), "plain_ms": plain_s * 1e3}


def grad_check(dev, n=50_000, seed=SEED):
    """One step's gradients through the kernels (card) and the plain
    versions (CPU tensors) on a reduced scene: relative L2 error per leaf,
    and the same for the control -- the kernel path with K2's f32 gradient
    rows rounded to bf16 (as a kernel that wrote them in the aux dtype
    would), through a tensor hook on the blend's payload."""
    from vegs_torch import convert
    from vegs_torch.config import VegsConfig
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.perf.refscale import origin_camera
    from vegs_torch.train import loss_fn
    from vegs_torch.utils.synthetic import unit_normal_map

    h, w = 128, 512
    rng = np.random.default_rng(seed + 7)
    z = rng.uniform(1.5, 10.0, n)
    arrays = {
        "means": np.stack([rng.uniform(-0.5, 0.5, n) * z,
                           rng.uniform(-0.14, 0.14, n) * z, z], 1),
        "quats": rng.normal(size=(n, 4)),
        "log_scales": np.log(rng.uniform(0.01, 0.1, (n, 3))),
        "sh_dc": rng.normal(0, 0.5, (n, 1, 3)),
        "sh_rest": rng.normal(0, 0.1, (n, 15, 3)),
        "opacity_logit": rng.normal(0, 1.5, (n, 1)),
        "valid": np.ones(n, bool),
    }
    gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    normal = unit_normal_map(h, w, seed)
    cfg = RasterizeConfig(k_cap=1 << 21, k_pad=1 << 21)
    opt = VegsConfig().opt
    grads, times = {}, {}
    for run, d in (("card", dev), ("plain", torch.device("cpu")),
                   ("control", dev)):
        field = convert.field_from_numpy(arrays, device=d)
        tap = torch.zeros((n, 2), device=d, requires_grad=True)
        cam = origin_camera(h, w, 1.0, 0.3, d)
        args = (torch.from_numpy(gt).to(d), torch.from_numpy(normal).to(d))
        t0 = time.perf_counter()
        if run == "control":
            loss, st, _ = staged_loss(field, tap, cam, *args, 3,
                                      torch.zeros(3, device=d), opt, cfg)
            st.payload_f32.register_hook(
                lambda g: g.to(torch.bfloat16).to(torch.float32))
            dropped = st.binned.num_dropped
        else:
            loss, _, _, out = loss_fn(field, tap, cam, *args, 1.0, 3,
                                      torch.zeros(3, device=d), opt_cfg=opt,
                                      raster_cfg=cfg)
            dropped = out.num_dropped
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        if int(dropped):
            raise AssertionError("the gradient-check scene drops instances")
        grads[run] = {k: getattr(field, k).grad.cpu()
                      for k in convert.FIELD_KEYS[:-1]}
        grads[run]["means2d"] = tap.grad.cpu()
    errs = {"card": {}, "control": {}}
    for k, ref in grads["plain"].items():
        for run in errs:
            got = grads[run][k]
            if not torch.isfinite(got).all() or float(ref.norm()) == 0:
                raise AssertionError(f"step gradient {k}: not finite or zero")
            errs[run][k] = float((got - ref).norm() / ref.norm())
    return {"scene": f"{h}x{w}, {n} Gaussians, bf16 aux",
            "rel_l2_err": errs["card"],
            "reading": max(errs["card"].values()),
            "control_rel_l2_err": errs["control"],
            "control_reading": max(errs["control"].values()),
            "card_s": times["card"], "plain_cpu_s": times["plain"]}


def train_phase(scene, dev, card) -> dict:
    """The training path at full width on `scene`'s field (see phase 7)."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.ops import blend_cuda, satcull, segreduce
    from vegs_torch.render import render
    from vegs_torch.train import Trainer
    from vegs_torch.utils.synthetic import unit_normal_map

    cams = scene.getTrainCameras()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cfg, need_raw, need_pad = sized_config(scene.gaussians, cams, dev)
        for i, cam in enumerate(cams):  # ground truth: the unperturbed field
            out = render(cam, scene.gaussians,
                         config=cfg._replace(forward_only=True))
            if int(out.num_dropped):
                raise AssertionError("ground-truth render drops instances")
            cam.image = torch.clamp(out.rgb, 0, 1).cpu().numpy()
            cam.normal = unit_normal_map(H, W, seed=i)
    with torch.no_grad():
        scene.gaussians.sh_dc += 0.35
    tcfg = VegsConfig()
    tcfg.opt.densification_interval = DENSIFY_EVERY
    trainer = Trainer(tcfg, scene, raster_cfg=cfg, device=dev)
    k2_args, k3_args, k_loss = step_kernel_inputs(
        trainer, cams[TRAIN_CAMS[0]], TRAIN_FIRST_IT, dev)
    setup_s = time.perf_counter() - t0

    counters = {"K1": blend_cuda.blend, "K2": blend_cuda.blend_bwd,
                "K3": segreduce.segment_reduce_cols, "K4": satcull.satcount}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    steps = []
    its = range(TRAIN_FIRST_IT, TRAIN_FIRST_IT + TRAIN_STEPS)
    for it, ci in zip(its, TRAIN_CAMS):
        before = {k: c.launches for k, c in counters.items()}
        n_before = trainer.state.field.capacity
        t1 = time.perf_counter()
        m = trainer.train_iteration(it, camera=cams[ci])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        steps.append({"it": it, "cam": ci, "ms": dt * 1e3,
                      "densify": it % DENSIFY_EVERY == 0,
                      "launches": {k: c.launches - before[k]
                                   for k, c in counters.items()},
                      "capacity": [n_before, trainer.state.field.capacity],
                      **{k: m[k] for k in ("loss", "l1", "normal_loss",
                                            "num_dropped", "num_needed",
                                            "num_needed_raw")}})
        if m["num_dropped"]:
            raise AssertionError(f"step {it} dropped instances: {steps[-1]}")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and descending: {losses}")
    if abs(k_loss - losses[0]) > 1e-6 * abs(losses[0]):
        raise AssertionError(f"the loss of K2's and K3's inputs {k_loss} is "
                             f"not the first step's {losses[0]}")
    for st in steps:
        if any(v != 1 for v in st["launches"].values()):
            raise AssertionError(f"a step did not launch each kernel once: {st}")
    n_densify = sum(st["densify"] for st in steps)
    if n_densify != 1:
        raise AssertionError(f"{n_densify} densify events in the run")
    plain_steps = [st["ms"] for st in steps[1:] if not st["densify"]]
    with torch.inference_mode():  # capacities for the densified field
        new, re_raw, re_pad = sized_config(trainer.state.field, cams, dev)
    trainer.raster_cfg = trainer.raster_cfg._replace(
        k_cap=max(new.k_cap, trainer.raster_cfg.k_cap),
        k_pad=max(new.k_pad, trainer.raster_cfg.k_pad))
    res = {"steps": TRAIN_STEPS, "first_it": TRAIN_FIRST_IT,
           "capacity": trainer.state.field.capacity,
           "n_active": [N_REF, int(trainer.state.field.num_active())],
           "k_cap": cfg.k_cap, "k_pad": cfg.k_pad, "need_raw": need_raw,
           "need_pad": need_pad,
           "after_densify": {"need_raw": re_raw, "need_pad": re_pad,
                             "k_cap": trainer.raster_cfg.k_cap,
                             "k_pad": trainer.raster_cfg.k_pad},
           "loss": losses, "kernel_inputs_loss": k_loss,
           "ms_per_step": float(np.median(plain_steps)),
           "ms_steps": [st["ms"] for st in steps],
           "densify_step_ms": next(st["ms"] for st in steps if st["densify"]),
           "max_memory_allocated": peak, "launches": launches,
           "setup_s": setup_s, "per_step": steps}
    emit("train", card=card, **res)

    after = []

    def two_steps():
        for it, ci in zip(range(its.stop, its.stop + 2), TRAIN_CAMS):
            after.append(trainer.train_iteration(it, camera=cams[ci]))

    prof = profile_frames(two_steps)
    if any(m["num_dropped"] or not np.isfinite(m["loss"]) for m in after):
        raise AssertionError(f"steps on the densified field: {after}")
    emit("train_profile", card=card, steps=2,
         loss=[m["loss"] for m in after], **prof)
    res["k2_args"], res["k3_args"] = k2_args, k3_args
    return res


def sized_config(field, cams_augs, device):
    """Probe every view at a generous capacity and size k_cap/k_pad by the
    largest need + 5% (as bench.py does), with the sat cull on."""
    from vegs_torch.ops.rasterize import RasterizeConfig

    probe = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP, sat_cull=True,
                            forward_only=True)
    need_raw = need_pad = 0
    for cam in cams_augs:
        st = field_stage(field, cam.device_params(device), probe)
        total = int(st.rb.total)
        if total > PROBE_CAP:
            raise AssertionError(f"probe capacity {PROBE_CAP} < need {total}")
        need_raw = max(need_raw, total)
        need_pad = max(need_pad, int(st.binned.tile_starts[-1]))
    return RasterizeConfig(k_cap=r512(need_raw * 1.05),
                           k_pad=r512(need_pad * 1.05)), need_raw, need_pad


def write_field_ply(path: Path, n: int, seed: int) -> None:
    """A seeded synthetic trained field (SH degree 3) placed like bench.py:
    depth in [2, 60], x/y filling the 376x1408 frustum (fovx 1.2, fovy 0.4)
    so that nearly every Gaussian is visible."""
    from vegs_torch import gaussians
    from vegs_torch.scene import save_gaussian_ply

    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 60.0, n).astype(np.float32)
    u = rng.uniform(-0.95, 0.95, n)
    v = rng.uniform(-0.95, 0.95, n)
    xyz = np.stack([z * np.tan(0.6) * u, z * np.tan(0.2) * v, z], 1).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    scale = np.log(rng.uniform(0.002, 0.025, (n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n)
    opac = np.log(op / (1 - op)).astype(np.float32)
    f_dc = rng.uniform(-1.0, 1.5, (n, 3)).astype(np.float32)
    f_rest = rng.normal(0, 0.12, (n, 45)).astype(np.float32)
    field = gaussians.from_ply_arrays(xyz, f_dc, f_rest, opac, scale, rot,
                                      device="cpu")
    save_gaussian_ply(path, field)


def kernel_times(kernel, plain, library) -> dict:
    """The card's own ms per call (torch.profiler: the summed durations of
    the device operations each call launches, without host gaps) of a
    kernel's wrapper, its plain version and the library call, and the
    kernel's stream ms (CUDA events, host gaps included). A kernel of a few
    tens of microseconds behind a Python wrapper is timed by the former:
    between launches the stream waits on the host."""
    from vegs_torch.perf.timing import (DEVICE_OVER_STREAM, cuda_ms,
                                        device_profile)

    t = {"ms": device_profile(kernel)["device_ms"],
         "stream_ms": cuda_ms(kernel),
         "plain_ms": device_profile(plain)["device_ms"],
         "library_ms": device_profile(library)["device_ms"]}
    if t["ms"] > DEVICE_OVER_STREAM * t["stream_ms"]:
        raise AssertionError(f"device time over stream time: {t}")
    return t


def m2_check(data, card) -> dict:
    """M2 against its plain version on the probes' inputs ([K, 8] f32,
    [K, 16] bf16): bit-identical; card, plain, library (x.t().contiguous())
    and bound times. Returns the f32 case's line."""
    from vegs_torch.perf import micro3, roofline

    lines = []
    for name, x in (("f32", data.a8), ("bf16", data.a16)):
        got = micro3.transpose(x)
        ref = micro3.transpose_ref(x)
        bits = torch.int32 if x.element_size() == 4 else torch.int16
        ident = bool(torch.equal(got.view(bits), ref.view(bits)))
        b_ms, by = roofline.bound_ms(
            roofline.Work(2 * x.numel() * x.element_size(), 0))
        line = {"dtype": name, "shape": list(x.shape), "bit_identical": ident,
                "max_abs_err": float((got.float() - ref.float()).abs().max()),
                **kernel_times(lambda: micro3.transpose(x),
                               lambda: micro3.transpose_ref(x),
                               lambda: x.t().contiguous()),
                "bound_ms": b_ms, "bound_by": by}
        emit("m2_check", card=card, **line)
        if not ident:
            raise AssertionError(f"M2 differs from its plain version: {line}")
        lines.append(line)
    return lines[0]


def m1_check(data, card) -> dict:
    """M1 against its plain version on the probes' inputs, f32 and bf16,
    [K, C] and [C, K]: |d| <= M1_RTOL * sum|x|, the control (the last
    2^17-long block left out) outside it, two runs bit-identical; card,
    plain, library (torch.sum in f32) and bound times. Returns the f32
    [K, C] case's line, with the largest |d| of all cases."""
    from vegs_torch.perf import micro3, roofline

    lines = []
    for name, x in (("f32", data.a8), ("bf16", data.a16)):
        for layout, y in (("[K, C]", x), ("[C, K]", x.t().contiguous())):
            got = micro3.psum_consume(y)
            again = micro3.psum_consume(y)
            parts = micro3.psum_parts_ref(y)
            ref = float(parts.sum())
            mag = float(y.float().abs().sum())
            d = abs(float(got) - ref)
            b_ms, by = roofline.bound_ms(roofline.Work(
                y.numel() * y.element_size(), y.numel()))
            line = {"dtype": name, "layout": layout, "shape": list(y.shape),
                    "value": float(got), "plain_value": ref, "abs_sum": mag,
                    "max_abs_err": d, "reading": d / mag,
                    "control_reading": abs(float(parts[:-1].sum()) - ref) / mag,
                    "limit": M1_RTOL,
                    "repeatable": bool(torch.equal(got, again)),
                    **kernel_times(
                        lambda: micro3.psum_consume(y),
                        lambda: micro3.psum_consume_ref(y),
                        lambda: torch.sum(y, dtype=torch.float32)),
                    "bound_ms": b_ms, "bound_by": by}
            emit("m1_check", card=card, **line)
            hold(f"M1 {name} {layout}", line["reading"], M1_RTOL,
                 line["control_reading"])
            if not line["repeatable"]:
                raise AssertionError(f"M1 differs between two runs: {line}")
            lines.append(line)
    return {**lines[0], "max_abs_err": max(ln["max_abs_err"] for ln in lines)}


def perf_phase(dev, card) -> dict:
    """The measurement path (see phase 10). Returns the M1 and M2 check
    lines and the launches of every kernel in the path."""
    from vegs_torch.ops import blend_cuda, satcull, segreduce
    from vegs_torch.perf import micro3, refscale, roofline

    t0 = time.perf_counter()
    data = micro3.make_data(dev)
    res = {"M2": m2_check(data, card), "M1": m1_check(data, card)}
    counters = {"K1": blend_cuda.blend, "K2": blend_cuda.blend_bwd,
                "K3": segreduce.segment_reduce_cols, "K4": satcull.satcount,
                "M1": micro3.psum_consume, "M2": micro3.transpose}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    micro3.run(device=dev, data=data,
               emit=lambda **kw: emit("micro3", **kw))
    del data
    rs = refscale.run(device=dev, work=True,
                      emit=lambda **kw: emit("refscale", **kw))
    res["launches"] = {k: c.launches for k, c in counters.items()}
    roofline.table(rs, emit=lambda **kw: emit("roofline", **kw))
    emit("perf", launches=res["launches"], counts=rs["counts"],
         seconds=time.perf_counter() - t0, card=card)
    missing = [k for k, v in res["launches"].items() if not v]
    if missing:
        raise AssertionError(f"the perf path never launched {missing}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (HERE / "vegs_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a vegs checkout "
              "(vegs_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vegs_torch import kernels
    from vegs_torch.ops import blend_cuda, satcull
    from vegs_torch.ops.rasterize import (RasterizeConfig,
                                          SAT_MIN_SLOTS_PER_TILE, stage)
    from vegs_torch.perf import roofline
    from vegs_torch.perf.refscale import origin_camera, random_gaussians
    from vegs_torch.perf.timing import card_line, cuda_ms
    from vegs_torch.render import render
    from vegs_torch.render_video import (DEFAULT_AUG_PARAMS, interpolate_cameras,
                                         render_frames)
    from vegs_torch.scene import Scene
    from vegs_torch.scene.cameras import make_camera_like_input_camera
    from vegs_torch.scene.dataset_readers import SceneInfo, getNerfppNorm
    from vegs_torch.utils.synthetic import street_camera_infos

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit("device", kind=kind, card=card, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    b = kernels.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "smem" in ln]
             for name, log in b["ptxas"].items()}
    emit("build", seconds=b["seconds"], built=b["built"], ptxas=ptxas,
         dir=str(kernels.build_dir().relative_to(HERE)))

    # -- 3. K4 at a saturating reduced scene --------------------------------
    rng = np.random.default_rng(SEED)
    small_cam = origin_camera(128, 512, 1.0, 0.3, dev)
    arrs = [torch.from_numpy(x).to(dev) for x in random_gaussians(
        rng, 60_000, (1.5, 10.0), 3.0, (0.1, 0.6), (0.5, 0.99))]
    cfg = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP, sat_cull=True,
                          forward_only=True)
    st = stage(*arrs, small_cam, config=cfg)
    cfg = cfg._replace(k_cap=r512(int(st.rb.total) * 1.05),
                       k_pad=r512(int(st.binned.tile_starts[-1]) * 1.05))
    st = stage(*arrs, small_cam, config=cfg)
    if int(st.binned.num_dropped):
        raise AssertionError("reduced K4 scene drops instances")
    k4_small = compare_k4(st)
    emit("k4_check", scene="128x512, 60k Gaussians", card=card, **k4_small)

    # -- 4. K1 at a reduced scene, f32 and bf16 aux ------------------------
    arrs = [torch.from_numpy(x).to(dev) for x in random_gaussians(
        rng, 30_000, (1.5, 10.0), 3.0, (0.03, 0.3))]
    k1_small = {}
    for aux in ("f32", "bf16"):
        cfg = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP,
                              payload_dtype=aux, forward_only=True)
        st = stage(*arrs, small_cam, config=cfg)
        cfg = cfg._replace(k_cap=r512(int(st.rb.total) * 1.05),
                           k_pad=r512(int(st.binned.tile_starts[-1]) * 1.05))
        st = stage(*arrs, small_cam, config=cfg)
        k1_small[aux] = compare_k1(st)
        emit("k1_check", scene="128x512, 30k Gaussians", aux=aux, card=card,
             **k1_small[aux])

    # -- 5. the main path at full width -------------------------------------
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        write_field_ply(Path(model_dir) / "point_cloud" / "iteration_1"
                        / "point_cloud.ply", N_REF, SEED)
        infos = street_camera_infos(3, H, W, fovx=1.2, fovy=0.4)
        info = SceneInfo(point_cloud=None, train_cameras=infos, test_cameras=[],
                         nerf_normalization=getNerfppNorm(infos), ply_path="")
        scene = Scene(model_dir, info, load_iteration=-1, shuffle=False,
                      device=dev)
        setup_s = time.perf_counter() - t0
    n_interp, max_frames = 4, 3
    cams = interpolate_cameras(scene.getTrainCameras(), n_interp)[:max_frames]
    views = [make_camera_like_input_camera(c, **a)
             for a in DEFAULT_AUG_PARAMS for c in cams]
    with torch.inference_mode():
        cfg, need_raw, need_pad = sized_config(scene.gaussians, views, dev)
        if cfg.k_cap < SAT_MIN_SLOTS_PER_TILE * 2112:
            raise AssertionError("the sat-cull gate should be on at this scale")
        for v in views:  # the capacities drop nothing on any frame
            nd = int(field_stage(scene.gaussians, v.device_params(dev),
                                 cfg._replace(forward_only=True)).binned.num_dropped)
            if nd:
                raise AssertionError(f"{nd} instances dropped at {cfg}")
        # warm the allocator and the libraries on one frame
        render(views[0], scene.gaussians, config=cfg._replace(forward_only=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blend_cuda.blend.launches = 0
    satcull.satcount.launches = 0
    t0 = time.perf_counter()
    frames = render_frames(scene, n_interp=n_interp, max_frames=max_frames,
                           raster_cfg=cfg)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    render_launches = {"K1": blend_cuda.blend.launches,
                       "K4": satcull.satcount.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    n_frames = sum(len(f) for f in frames.values())
    if n_frames < 8:
        raise AssertionError(f"only {n_frames} frames rendered")
    for name, fr in frames.items():
        for f in fr:
            if f.shape != (H, W, 3) or not np.isfinite(f).all():
                raise AssertionError(f"{name}: bad frame {f.shape}")
            if f.min() < 0 or f.max() > 1:
                raise AssertionError(f"{name}: frame outside [0, 1]")
    if min(render_launches.values()) < n_frames:
        raise AssertionError(f"kernel launches {render_launches} < "
                             f"{n_frames} frames")
    emit("main", frames=n_frames, trajectories=list(frames), n=N_REF,
         capacity=scene.gaussians.capacity, k_cap=cfg.k_cap, k_pad=cfg.k_pad,
         need_raw=need_raw, need_pad=need_pad, launches=render_launches,
         frame_mean=[float(np.mean(f[0])) for f in frames.values()],
         setup_s=setup_s, card=card)

    # sat cull on vs off on one frame: bit-identical, and coverage
    view = views[0]
    with torch.inference_mode():
        probe_off = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP,
                                    sat_cull=False, forward_only=True)
        need_off = int(field_stage(scene.gaussians, view.device_params(dev),
                                   probe_off).binned.tile_starts[-1])
        on = render(view, scene.gaussians,
                    config=cfg._replace(forward_only=True, sat_cull=True))
        off = render(view, scene.gaussians,
                     config=cfg._replace(forward_only=True, sat_cull=False,
                                         k_pad=r512(need_off * 1.05)))
        ident = {k: bool(torch.equal(getattr(on, k), getattr(off, k)))
                 for k in ("rgb", "depth", "alpha")}
        dropped = (int(on.num_dropped), int(off.num_dropped))
        coverage = float((on.alpha > 0.5).float().mean())
    emit("satcull_lossless", bit_identical=ident, num_dropped=dropped,
         padded_slots={"on": int(on.num_needed), "off": int(off.num_needed)},
         alpha_coverage=coverage, card=card)
    if not all(ident.values()) or any(dropped):
        raise AssertionError("sat cull on/off renders differ or drop")
    if coverage < 0.5:
        raise AssertionError(f"alpha coverage {coverage} is trivial")

    # kernels against their plain versions on this frame's inputs
    with torch.inference_mode():
        st = field_stage(scene.gaussians, view.device_params(dev),
                         cfg._replace(forward_only=True))
        k4_full = compare_k4(st)
        emit("k4_check", scene="376x1408, 2,233,571 Gaussians", card=card,
             **k4_full)
        k1_full = compare_k1(st)
        emit("k1_check", scene="376x1408, 2,233,571 Gaussians", aux="bf16",
             card=card, **k1_full)

        # -- 6. timing at the full-width shapes --------------------------------
        grid = st.grid
        hp, wp = grid.padded_height, grid.padded_width
        ts = st.binned.tile_starts
        k1_ms = cuda_ms(lambda: blend_cuda.blend(
            st.payload_f32, st.payload_aux, ts, grid, hp, wp))
        k4_ms = cuda_ms(lambda: satcull.satcount(st.pf_sorted,
                                                 st.rb.raw_starts, grid))
        # bounds: the work this frame's inputs need, from the plain
        # versions' records
        k1_pairs, k4_pairs = {}, {}
        blend_cuda.blend_ref_tiles(st.payload_f32, st.payload_aux, ts, grid,
                                   hp, wp, pairs=k1_pairs)
        satcull.satcount_ref(st.pf_sorted, st.rb.raw_starts, grid,
                             pairs=k4_pairs)
        k1_bytes, k1_ops = roofline.k1_work(
            k1_pairs, st.payload_aux.element_size(), grid.num_tiles, hp, wp)
        k4_bytes, k4_ops = roofline.k4_work(k4_pairs, grid.num_tiles)

    k1_bound, k1_by = roofline.bound_ms(roofline.Work(k1_bytes, k1_ops))
    k4_bound, k4_by = roofline.bound_ms(roofline.Work(k4_bytes, k4_ops))
    emit("timing", card=card, kind=kind,
         ms_per_frame=main_s / n_frames * 1e3,
         k1_ms=k1_ms, k4_ms=k4_ms,
         k1_plain_ms=k1_full["plain_ms"], k4_plain_ms=k4_full["plain_ms"],
         k1_plain_ms_reduced={a: r["plain_ms"] for a, r in k1_small.items()},
         k4_plain_ms_reduced=k4_small["plain_ms"],
         k1_bound_ms=k1_bound, k1_bound_by=k1_by, k1_pairs=k1_pairs,
         k1_ops=k1_ops, k1_bytes=k1_bytes, k4_bound_ms=k4_bound,
         k4_bound_by=k4_by, k4_pairs=k4_pairs, k4_ops=k4_ops,
         k4_bytes=k4_bytes,
         max_memory_allocated=peak_mem)

    # where a frame's time goes: 4 frames (one per trajectory) under the
    # profiler, after the main path (the profiler's cost is not in the
    # per-frame time above)
    def four_frames():
        with torch.inference_mode():
            for a in DEFAULT_AUG_PARAMS:
                v = make_camera_like_input_camera(cams[1], **a)
                render(v, scene.gaussians,
                       config=cfg._replace(forward_only=True)).rgb.cpu()

    emit("profile", card=card, frames=len(DEFAULT_AUG_PARAMS),
         **profile_frames(four_frames))

    # -- 7. the training path at full width ---------------------------------
    train = train_phase(scene, dev, card)

    # -- 8. K2 and K3 on the first step's inputs -----------------------------
    k2_args, k3_args = train.pop("k2_args"), train.pop("k3_args")
    k2 = compare_k2(k2_args)
    k2_ms = cuda_ms(lambda: blend_cuda.blend_bwd(*k2_args))
    pf, pa, ts2, out2, dout2, grid2 = k2_args
    hp2, wp2 = grid2.padded_height, grid2.padded_width
    k2_bytes, k2_ops = roofline.k2_work(k2["pairs"], pa.element_size(),
                                        pf.shape[1], grid2.num_tiles, hp2, wp2)
    k2_bound, k2_by = roofline.bound_ms(roofline.Work(k2_bytes, k2_ops))
    emit("k2_check", scene="376x1408, 2,233,571 Gaussians, first train step",
         aux=str(pa.dtype), card=card, ms=k2_ms, bound_ms=k2_bound,
         bound_by=k2_by, ops=k2_ops, bytes=k2_bytes,
         limit=K2_RTOL, held=K2_SCALE, **k2)
    for rows, scale in K2_SCALE.items():
        hold(f"K2 {rows} by {scale}", k2[rows]["reading"][scale], K2_RTOL,
             k2[rows]["control_reading"][scale])
    if k2["flip_tiles"] > K2_MAX_FLIP_TILES * grid2.num_tiles:
        raise AssertionError(f"K2: {k2['flip_tiles']} stop-flip tiles")

    from vegs_torch.ops import segreduce

    k3 = compare_k3(k3_args)
    cols, starts, ends = k3_args
    k3_ms = cuda_ms(lambda: segreduce.segment_reduce_cols(*k3_args))
    total = int(ends[-1])
    data = cols[:, :total].contiguous()
    lengths = (ends - starts).long().expand(cols.shape[0], -1).contiguous()
    lib = torch.segment_reduce(data, "sum", lengths=lengths, axis=1)
    lib_err = float((lib - segreduce.segment_reduce_cols(*k3_args)).abs().max())
    k3_lib_ms = cuda_ms(lambda: torch.segment_reduce(
        data, "sum", lengths=lengths, axis=1))
    k3_bytes, k3_ops = roofline.k3_work(cols.shape[0], total, starts.shape[0])
    k3_bound, k3_by = roofline.bound_ms(roofline.Work(k3_bytes, k3_ops))
    emit("k3_check", scene="376x1408, 2,233,571 Gaussians, first train step",
         card=card, ms=k3_ms, library_ms=k3_lib_ms, library_max_abs_err=lib_err,
         bound_ms=k3_bound, bound_by=k3_by, bytes=k3_bytes, ops=k3_ops,
         limit=K3_RTOL, **k3)
    hold("K3", k3["reading"], K3_RTOL, k3["control_reading"])
    del k2_args, k3_args, data, lengths, lib

    # -- 9. one step's gradients: kernels against plain versions -------------
    grad = grad_check(dev)
    emit("grad_check", card=card, limit=GRAD_RTOL, **grad)
    hold("step gradients", grad["reading"], GRAD_RTOL,
         grad["control_reading"])

    # -- 10. the measurement path, on a card freed of the earlier phases ----
    del scene, views, frames, st, on, off
    torch.cuda.empty_cache()
    perf = perf_phase(dev, card)

    # -- 11. summary ---------------------------------------------------------
    launches = {**train["launches"]}
    m1, m2 = perf["M1"], perf["M2"]
    perf_only = "the perf phase (micro3 probes); the main paths never launch it"
    print(json.dumps({"kernels": [
        {"name": "K1 blend_fwd", "route": "cuda",
         "source": "vegs_torch/csrc/blend_fwd.cu",
         "replaces": "vegs_tpu/ops/blend_pallas.py:201",
         "launches": launches["K1"], "matches_plain": True,
         "max_abs_err": k1_full["max_abs_err"],
         "stop_flips": k1_full["stop_flips"],
         "ms": k1_ms, "plain_ms": k1_full["plain_ms"],
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "K2 blend_bwd", "route": "cuda",
         "source": "vegs_torch/csrc/blend_bwd.cu",
         "replaces": "vegs_tpu/ops/blend_pallas.py:274",
         "launches": launches["K2"], "matches_plain": True,
         "max_abs_err": k2["max_abs_err"],
         "reading": max(k2[rows]["reading"][scale]
                        for rows, scale in K2_SCALE.items()),
         "flip_tiles": k2["flip_tiles"],
         "ms": k2_ms, "plain_ms": k2["plain_ms"],
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "K3 segreduce", "route": "cuda",
         "source": "vegs_torch/csrc/segreduce.cu",
         "replaces": "vegs_tpu/ops/segreduce.py:46",
         "launches": launches["K3"], "matches_plain": True,
         "max_abs_err": k3["max_abs_err"],
         "ms": k3_ms, "plain_ms": k3["plain_ms"],
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib_ms},
        {"name": "K4 satcount", "route": "cuda",
         "source": "vegs_torch/csrc/satcount.cu",
         "replaces": "vegs_tpu/ops/satcull.py:65",
         "launches": launches["K4"], "matches_plain": True,
         "max_abs_err": k4_full["max_abs_err"],
         "ms": k4_ms, "plain_ms": k4_full["plain_ms"],
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None},
        {"name": "M1 blocksum", "route": "cuda",
         "source": "vegs_torch/csrc/blocksum.cu",
         "replaces": "perf/micro3_r02.py:56",
         "launches": perf["launches"]["M1"], "launched_by": perf_only,
         "matches_plain": True, "max_abs_err": m1["max_abs_err"],
         "case": f"{m1['dtype']} {m1['layout']}",
         "ms": m1["ms"], "plain_ms": m1["plain_ms"],
         "bound_ms": m1["bound_ms"], "bound_by": m1["bound_by"],
         "library_ms": m1["library_ms"]},
        {"name": "M2 transpose", "route": "cuda",
         "source": "vegs_torch/csrc/transpose.cu",
         "replaces": "perf/micro3_r02.py:107",
         "launches": perf["launches"]["M2"], "launched_by": perf_only,
         "matches_plain": True, "max_abs_err": m2["max_abs_err"],
         "case": m2["dtype"],
         "ms": m2["ms"], "plain_ms": m2["plain_ms"],
         "bound_ms": m2["bound_ms"], "bound_by": m2["bound_by"],
         "library_ms": m2["library_ms"]},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
