"""Quality runs of the fully sharded trainer on the ray-traced street oracle:
port of the JAX package's TP quality harness (perf/quality_tp.py,
quality_tp_full.py, quality_tp_r05.py, quality_tp_r05b_adapter.py).

The same scene, initialization and camera order train once through the
single-device step (`train.train_step` with one `BoxStep`) and once through
the fully sharded step (`parallel.tp_trainer.make_tp_full_train_step`) in
`NDEV` ranks that `parallel.launch.spawn` starts: the static field, the box
slot's canonical field and their densify statistics sharded over the ranks,
the per-frame box residuals replicated, shard-local densify and prune
(`tp_densify_and_prune`) in the loop. Four runs, each held against the
reading the JAX package recorded for the same recipe:

- `seeds` (QUALITY_TP_r05): 32x64, 9 cameras with the mover, 300
  iterations, densify [100, 260] every 80 at tau 4e-4, k_cap 8192; single
  against TP at seeds 0-2 (each seed sets the camera order and the split
  draws). Seed 0's TP run starts at k_cap 2^15 with a live `KCapAdapter`
  (floor 512, decay window 30; every return rebuilds the step and its tile
  plan) and, at each densify event, the mask report: `densify_masks` on the
  state gathered in rank order against each rank's own masks. The spread
  of the three single-device finals sets the band (`PSNR_BAND_DB`).
- `full` (QUALITY_TP_r04): single against TP over 500 iterations, an
  evaluation every 50, densify [100, 400] every 100.
- `static` (QUALITY_TP_r02): the static TP step (`make_tp_train_step`) on
  the scene without the mover at 48x96, 150 iterations, densify at 100 and
  150, k_cap re-chosen by `kcap_for` after each event, an evaluation every
  25.
- `adapter` (QUALITY_TP_r05b): the TP run from k_cap 1024 (floor 512,
  window 25): the adapter grows out of real drops, a stale 32768 cap is
  swapped in at iteration 120, and it decays back.

On the card each rank holds its own CUDA context; with one card the ranks
share it and every collective is staged through the host ("gloo-host").
The readings are about quality and equivalence, not speed.

Run on the card:  python -m vegs_torch.perf.quality_tp
                  --run static|full|seeds|adapter [--out PATH]
The CLI writes only its report, QUALITY_TORCH_TP.md at the repository's
root (or --out), each run's record kept in a JSON block at its end, and
exits 1 when a held reading misses its limit. Functions take
`device="cpu"` for the CPU tests; without it they run on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import all_counters, launch_counts
from .quality import _card, _clone, _launches, _sync, psnr_band, within

ROOT = Path(__file__).resolve().parents[2]
REPORT = ROOT / "QUALITY_TORCH_TP.md"

# -- the runs' settings (quality_tp_full.py:48-58, quality_tp_r05.py:60-66,
# quality_tp_r05b_adapter.py:48-49, quality_tp.py:48-56) ---------------------
H, W, N_CAMS = 32, 64, 9
NDEV = 4
SCENE_SEED = 5             # numpy seed of the mover scene
BOX_NOISE_T = 0.06         # annotation noise (m)
K_CAP = 8192
EVAL_K_CAP = 1 << 14
SPATIAL = 6.0              # the spatial scale every run trains with
GRAD_THRESHOLD = 4e-4      # densify_grad_threshold (toy-scale NDC gradients)
BOX_LR_MULT, BOXMODEL_LR, BOXMODEL_LAMBDA_REG = 2.0, 1e-3, 1e-2
MIN_OPACITY = 0.005

SEEDS = (0, 1, 2)
R05_ITERS, R05_EVERY, R05_DENSIFY = 300, 100, (100, 260, 80)
R05_ADAPTER = (1 << 15, 512, 30)   # start k_cap, floor, decay window
R04_ITERS, R04_EVERY, R04_DENSIFY = 500, 50, (100, 400, 100)
R05B_ITERS, R05B_ADAPTER, R05B_SWAP = 240, (1024, 512, 25), (120, 32768)

STATIC_SEED, STATIC_HW = 0, (48, 96)
STATIC_POINTS = (700, 150, 1500)   # n_ground, n_box, n_sky
STATIC_ITERS, STATIC_EVERY = 150, 25
STATIC_DENSIFY = (50, 150, 50)     # events at from < it <= until
STATIC_EVAL_K_CAP = 1 << 15
STATIC_KEY, STATIC_CAM_SEED = 11, 3

# -- the JAX package's recorded readings --------------------------------------
# QUALITY_TP_r05.md §1-3 and §3b
JAX_R05 = {"single": (10.78, 10.87, 10.87), "tp": (10.69, 10.68, 11.03)}
JAX_R05_MASKS = {160: ([0, 341, 1], [0, 0, 0]), 240: ([0, 533, 37], [0, 0, 0])}
JAX_BOX_ERR_RAW = 0.109
BOX_ERR_TOL = 1e-3
JAX_R05_ADAPTER = [(30, "decay", 16384), (60, "decay", 8192)]
JAX_R05B = [(1, "grow", 2048), (2, "grow", 4096), (120, "stale-resume", 32768),
            (144, "decay", 16384), (169, "decay", 8192)]
# QUALITY_TP_r04.md: held-out PSNR by iteration, single and TP
JAX_R04 = {
    "single": {0: 5.71, 50: 6.77, 100: 7.68, 150: 8.38, 200: 8.90, 250: 9.71,
               300: 10.44, 350: 11.25, 400: 12.10, 450: 12.70, 500: 13.05},
    "tp": {0: 5.71, 50: 6.77, 100: 7.81, 150: 8.65, 200: 9.30, 250: 10.30,
           300: 10.86, 350: 11.80, 400: 12.67, 450: 13.36, 500: 13.73}}
# QUALITY_TP_r02.md: held-out PSNR and active Gaussians by iteration
JAX_R02 = {0: (5.81, 2824), 25: (6.45, 2824), 50: (7.20, 2824),
           75: (7.72, 2824), 100: (8.14, 3280), 125: (8.61, 3280),
           150: (8.95, 3980)}

# Set from the single-device finals of seeds 0-2 on the card, before any
# TP run was read (an NVIDIA H100 80GB HBM3 at 700 W read 11.374, 10.434,
# 10.974 dB).
SEED_PSNR_STD = 0.4717643237768698
PSNR_BAND_DB = psnr_band(SEED_PSNR_STD)


# -- the scene ----------------------------------------------------------------


@dataclasses.dataclass
class Oracle:
    """A ray-traced street scene: the seeded static field, the mover's
    canonical field (None without it), the idx % 8 split of the cameras
    and the mover's box-to-world per frame, true and annotated (noisy)."""

    field: object
    bfield: object
    train_cams: list
    test_cams: list
    true_b2w: dict
    noisy_b2w: dict
    _inputs: dict = dataclasses.field(default_factory=dict, repr=False)

    def inputs(self, cam, device):
        """(frame, gt, world normal, noisy box-to-world [1, 4, 4] or None,
        camera parameters) of `cam` on `device`, made once."""
        key = (cam.uid, str(device))
        if key not in self._inputs:
            f = int(cam.frame)
            t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                          device=device)
            wn = cam.world_normal()
            normal = (t(wn) if wn is not None else
                      torch.zeros((3, cam.image_height, cam.image_width),
                                  device=device))
            b2w = t(self.noisy_b2w[f])[None] if self.noisy_b2w else None
            self._inputs[key] = (f, t(cam.original_image), normal, b2w,
                                 cam.device_params(device))
        return self._inputs[key]


def _split(cams):
    return ([c for i, c in enumerate(cams) if i % 8 != 0],
            [c for i, c in enumerate(cams) if i % 8 == 0])


def build_scene(rng, device=None) -> Oracle:
    """The mover scene (quality_tp_full.py:61-86): N_CAMS street frames
    ray-traced with the mover and normal maps, `sample_scene_points(
    n_ground=400, n_box=100, n_sky=600)` at capacity round_capacity(n, 512),
    the mover's 96 canonical points in 128 rows, then per frame its true
    box-to-world and one with 0.06 m of translation noise, all drawn from
    `rng` in the JAX function's order."""
    from .. import gaussians
    from ..scene.dataset_readers import camera_from_info
    from ..utils import synthetic as syn

    dev = resolve_device(device)
    infos = syn.street_camera_infos(N_CAMS, H, W, render_gt=True,
                                    moving_box=True, render_normal=True)
    train_cams, test_cams = _split([camera_from_info(ci) for ci in infos])
    pts, cols = syn.sample_scene_points(rng, n_ground=400, n_box=100,
                                        n_sky=600)
    field = gaussians.create_from_points(
        pts, cols, capacity=gaussians.round_capacity(pts.shape[0], 512),
        device=dev)
    canon, ccols = syn.mover_canonical_points(rng, n=96)
    bfield = gaussians.create_from_points(canon, ccols, capacity=128,
                                          device=dev)
    true_b2w, noisy_b2w = {}, {}
    for f in range(N_CAMS):
        m = syn.mover_box2world(f, N_CAMS)
        true_b2w[f] = m
        noise = np.eye(4, dtype=np.float32)
        noise[:3, 3] = rng.normal(0, BOX_NOISE_T, 3).astype(np.float32)
        noisy_b2w[f] = (noise @ m).astype(np.float32)
    return Oracle(field, bfield, train_cams, test_cams, true_b2w, noisy_b2w)


def build_static_scene(rng, device=None) -> Oracle:
    """The r02 scene (quality_tp.py:60-84): no mover, no normal maps,
    `sample_scene_points(n_ground=700, n_box=150, n_sky=1500)`."""
    from .. import gaussians
    from ..scene.dataset_readers import camera_from_info
    from ..utils import synthetic as syn

    dev = resolve_device(device)
    infos = syn.street_camera_infos(N_CAMS, *STATIC_HW, render_gt=True)
    train_cams, test_cams = _split([camera_from_info(ci) for ci in infos])
    n_ground, n_box, n_sky = STATIC_POINTS
    pts, cols = syn.sample_scene_points(rng, n_ground=n_ground, n_box=n_box,
                                        n_sky=n_sky)
    field = gaussians.create_from_points(
        pts, cols, capacity=gaussians.round_capacity(pts.shape[0], 512),
        device=dev)
    return Oracle(field, None, train_cams, test_cams, {}, {})


def camera_order(scene: Oracle, seed: int, iters: int):
    """The training cameras of iterations 1..iters: uniform draws from
    `np.random.default_rng(17 + seed)` (quality_tp_r05.py:98)."""
    r = np.random.default_rng(17 + seed)
    return [scene.train_cams[int(r.integers(len(scene.train_cams)))]
            for _ in range(iters)]


# -- evaluation ---------------------------------------------------------------


@torch.no_grad()
def evaluate(scene: Oracle, field, bfield=None, deltas=None,
             k_cap: int = EVAL_K_CAP) -> float:
    """Mean held-out PSNR (quality_tp_full.py:89-110): each test camera
    renders the static field, and with `bfield` the box field moved by its
    frame's annotated box-to-world adjusted by the frame's residual
    (`deltas`: {frame: BoxDeltas}, identity where absent), on a black
    background, clipped to [0, 1]."""
    from ..boxmodel import BoxDeltas, adjust_box2world
    from ..losses import psnr
    from ..ops.rasterize import RasterizeConfig
    from ..render import (_concat_arrays, _run, field_arrays,
                          transform_field_arrays)

    dev = field.means.device
    cfg = RasterizeConfig(k_cap=k_cap, forward_only=True)
    vals = []
    for c in scene.test_cams:
        f, gt, _, b2w, cam = scene.inputs(c, dev)
        parts = [field_arrays(field, 3)]
        if bfield is not None:
            d = (deltas or {}).get(f)
            d = BoxDeltas.identity(dev) if d is None else d
            parts.append(transform_field_arrays(
                field_arrays(bfield, 3), adjust_box2world(b2w[0], d)))
        out = _run(cam, _concat_arrays(parts), bg=torch.zeros(3, device=dev),
                   scale_modifier=1.0, override_color=None, sh_degree=3,
                   config=cfg, means2d_offset=None)
        vals.append(float(psnr(torch.clamp(out.rgb, 0, 1), gt)))
    return float(np.mean(vals))


def box_errors(scene: Oracle, deltas: dict) -> tuple:
    """(mean translation error of the annotation adjusted by its frame's
    residual, of the raw annotation) against the true pose, over the
    train frames (quality_tp_r05.py:109)."""
    from ..boxmodel import adjust_box2world

    adj_e, raw_e = [], []
    for c in scene.train_cams:
        f = int(c.frame)
        noisy, true = scene.noisy_b2w[f], scene.true_b2w[f]
        d = deltas[f]
        adj = adjust_box2world(torch.as_tensor(noisy, device=d.delta_t.device),
                               d).detach().cpu().numpy()
        adj_e.append(np.linalg.norm(adj[:3, 3] - true[:3, 3]))
        raw_e.append(np.linalg.norm(noisy[:3, 3] - true[:3, 3]))
    return float(np.mean(adj_e)), float(np.mean(raw_e))


# -- settings shared by both loops --------------------------------------------


def opt_config(grad_threshold: float = GRAD_THRESHOLD):
    """OptimizationParams with the scripts' overrides: the densify
    threshold, and box_lr_mult (the single-device step reads it from the
    config; the TP step takes it as an argument)."""
    from ..config import OptimizationParams

    cfg = OptimizationParams()
    cfg.densify_grad_threshold = grad_threshold
    cfg.box_lr_mult = BOX_LR_MULT
    return cfg


def densify_at(it: int, sched, strict_from: bool = False) -> bool:
    """Whether `it` is a densify event of `sched` = (from, until, every)
    (None: never); `strict_from` as quality_tp.py counts (from < it)."""
    if sched is None:
        return False
    lo, hi, every = sched
    return (lo < it if strict_from else lo <= it) and it <= hi \
        and it % every == 0


def _split_seed(seed: int, it: int) -> int:
    # the JAX scripts key each event jax.random.key(100 + it + 1000 seed)
    return 100 + it + 1000 * seed


def _noise(noise, it, rank=None):
    """The replayed split draws of event `it` (the tests hand the JAX
    package's draws in), or None: the run draws its own."""
    if not noise or it not in noise:
        return None
    x = noise[it] if rank is None else noise[it][rank]
    return torch.as_tensor(np.asarray(x, np.float32))


class AdapterLog:
    """The adapter's transitions as the scripts record them
    (quality_tp_r05.py:193-206, quality_tp_r05b_adapter.py:123-145): at
    `swap` = (it, k_cap) a stale cap replaces the adapter's ("stale-resume");
    each non-None return of `KCapAdapter.update` is a "grow" when the step
    dropped instances, else a "decay". `observe` returns the k_cap the step
    must be rebuilt at, or None."""

    def __init__(self, adapter, swap=None):
        self.adapter, self.swap, self.events = adapter, swap, []

    def observe(self, it: int, dropped: float, needed: float):
        rebuild = None
        if self.swap is not None and it == self.swap[0]:
            self.adapter.k_cap = int(self.swap[1])
            self.adapter._low_streak = 0
            self.events.append((it, "stale-resume", int(self.swap[1])))
            rebuild = int(self.swap[1])
        new = self.adapter.update(float(dropped), float(needed))
        if new is not None:
            self.events.append((it, "grow" if dropped > 0 else "decay",
                                int(new)))
            rebuild = int(new)
        return rebuild


# -- the single-device loop ---------------------------------------------------


def run_single(scene: Oracle, *, seed: int = 0, iters: int = R05_ITERS,
               every: Optional[int] = R05_EVERY, densify=R05_DENSIFY,
               k_cap: int = K_CAP, grad_threshold: float = GRAD_THRESHOLD,
               noise: Optional[dict] = None, log=print) -> dict:
    """The single-device arm (quality_tp_r05.py:129-158): the functional
    step `train.train_step` with one `BoxStep` on the scene's device,
    `densify.densify_and_prune` at every event of `densify` (split draws
    from a generator seeded 100 + it + 1000 seed, or `noise`), an
    evaluation at 0, every `every` and at the end. Returns the record."""
    from .. import densify as D, optim
    from ..boxmodel import BoxDeltas
    from ..config import BoxModelParams
    from ..gaussians import DensifyStats
    from ..ops.rasterize import RasterizeConfig
    from ..train import BoxStep, TrainState, train_step

    field = _clone(scene.field)
    dev = field.means.device
    cfg = opt_config(grad_threshold)
    box_cfg = BoxModelParams(boxmodel_lr=BOXMODEL_LR,
                             boxmodel_lambda_reg=BOXMODEL_LAMBDA_REG)
    raster = RasterizeConfig(k_cap=k_cap)
    bg = torch.zeros(3, device=dev)
    state = TrainState(field=field, opt=optim.adam_init(field),
                       stats=DensifyStats.zeros(field.capacity, dev), step=0)
    bf = _clone(scene.bfield)
    bopt, bstats = optim.adam_init(bf), DensifyStats.zeros(bf.capacity, dev)
    ident = BoxDeltas.identity(dev)
    deltas = {f: (ident, optim.tensor_adam_init(ident.as_dict()))
              for f in range(len(scene.noisy_b2w))}
    launch0, t0 = _launches(), time.perf_counter()
    trend, losses, step_ms, events = [], [], [], []

    def evaluate_at(it):
        p = evaluate(scene, state.field, bf, {f: d for f, (d, _) in
                                             deltas.items()})
        trend.append({"it": it, "psnr": p,
                      "n": int(state.field.num_active())})
        log(f"[single seed {seed}] it {it}: psnr {p:.4f} "
            f"n {trend[-1]['n']} ({time.perf_counter() - t0:.1f} s)")

    evaluate_at(0)
    for it, c in enumerate(camera_order(scene, seed, iters), start=1):
        f, gt, normal, b2w, cam = scene.inputs(c, dev)
        d, dopt = deltas[f]
        ts = time.perf_counter()
        state, met, (box,) = train_step(
            state, cam, gt, normal, 1.0, 3, bg, opt_cfg=cfg,
            raster_cfg=raster, spatial_scale=SPATIAL,
            boxes=(BoxStep(field=bf, opt=bopt, stats=bstats,
                           box2world=b2w[0], deltas=d, delta_opt=dopt),),
            box_cfg=box_cfg)
        loss = float(met["loss"])
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if not np.isfinite(loss):
            raise FloatingPointError(f"[single seed {seed}] it {it}: {met}")
        losses.append(loss)
        bstats = box.stats
        deltas[f] = (box.deltas, box.delta_opt)
        if densify_at(it, densify):
            g = torch.Generator(device=dev).manual_seed(_split_seed(seed, it))
            f2, o2, s2, n = D.densify_and_prune(
                state.field, state.opt, state.stats, g,
                grad_threshold=cfg.densify_grad_threshold,
                percent_dense=cfg.percent_dense, extent=SPATIAL,
                noise=_noise(noise, it))
            state = TrainState(field=f2, opt=o2, stats=s2, step=state.step)
            events.append({"it": it, "n": int(n), "capacity": f2.capacity})
        if (every and it % every == 0) or it == iters:
            evaluate_at(it)
    now = _launches()
    err, raw = box_errors(scene, {f: d for f, (d, _) in deltas.items()})
    return {"trend": trend, "final_psnr": trend[-1]["psnr"],
            "box_err": err, "box_err_raw": raw, "losses": losses,
            "densify": events, "n_active": int(state.field.num_active()),
            "ms_per_step_median": statistics.median(step_ms),
            "wall_s": time.perf_counter() - t0,
            "launches": {k: now[k] - launch0[k] for k in now},
            "state": state, "box_field": bf, "deltas": deltas}


# -- the TP loops (in the ranks) ----------------------------------------------


def gather_field(field, comm):
    """The whole field from every rank's row block, in rank order."""
    from ..convert import FIELD_KEYS
    from ..gaussians import GaussianField
    from ..parallel.comm import all_gather

    out = {}
    for k in FIELD_KEYS:
        x = getattr(field, k).detach()
        if k == "valid":
            out[k] = all_gather(x.to(torch.uint8), comm).bool()
        else:
            out[k] = all_gather(x, comm)
    return GaussianField(**out)


def gather_stats(stats, comm):
    from ..gaussians import DensifyStats
    from ..parallel.comm import all_gather

    return DensifyStats(*[all_gather(getattr(stats, k), comm)
                          for k in ("max_radii2d", "xyz_gradient_accum",
                                    "denom")])


def mask_report(comm, field, stats, cfg) -> dict:
    """`densify_masks` on the state gathered in rank order (the global
    policy's decisions) against each rank's own masks gathered the same
    way (quality_tp_r05.py:208-229): clone/split/prune counts and the rows
    that differ, on every rank."""
    from ..densify import densify_masks
    from ..parallel.comm import all_gather

    args = (cfg.densify_grad_threshold, cfg.percent_dense, SPATIAL,
            MIN_OPACITY, 0)
    g_masks = densify_masks(gather_field(field, comm),
                            gather_stats(stats, comm), *args)
    l_masks = [all_gather(m.to(torch.uint8), comm).bool()
               for m in densify_masks(field, stats, *args)]
    return {"counts": [int(m.sum()) for m in g_masks],
            "diffs": [int((a != b).sum()) for a, b in zip(g_masks, l_masks)]}


def _agreed(comm, dropped, needed) -> tuple:
    """The step's (dropped, needed) as every rank read them. They come out
    of the step reduced over the axis; a rank that read other values would
    take another rebuild decision and deadlock the next collective, so
    this fails first."""
    from ..parallel.comm import all_gather

    dev = dropped.device
    mine = torch.stack([dropped.to(torch.int64).reshape(()),
                        needed.to(torch.int64).reshape(())]).to(dev)
    every = all_gather(mine[None], comm)
    if not bool((every == mine[None]).all()):
        raise AssertionError(f"ranks read different capacity signals: "
                             f"{every.tolist()}")
    return int(mine[0]), int(mine[1])


def _counts() -> dict:
    """Every kernel's launch count in this process: K1-K4 and the layout
    probes M1, M2."""
    return launch_counts(all_counters())


class _StepLaunches:
    """Launch counts accumulated over the training steps alone (the
    evaluations' renders are left out)."""

    def __init__(self):
        self.total = {k: 0 for k in _counts()}

    def __enter__(self):
        self.before = _counts()

    def __exit__(self, *exc):
        now = _counts()
        for k in now:
            self.total[k] += now[k] - self.before[k]


def _tp_full_loop(mesh, scene: Oracle, spec: dict, dev, log,
                  last: dict) -> dict:
    """One TP run of the mover scene in this rank (quality_tp_r05.py:
    160-240, quality_tp_r05b_adapter.py:75-145)."""
    from .. import densify as D, optim
    from ..boxmodel import BoxDeltas
    from ..gaussians import DensifyStats
    from ..ops.rasterize import RasterizeConfig
    from ..parallel.tp_trainer import (KCapAdapter, make_tp_full_train_step,
                                       shard_field, shard_train_state,
                                       tp_densify_and_prune)

    comm = mesh.comm()
    me, ndev = comm.index, comm.size
    seed, iters = spec["seed"], spec["iters"]
    cfg = opt_config(spec.get("grad_threshold", GRAD_THRESHOLD))
    full = _clone(scene.field)
    sf, so, ss = shard_train_state(mesh, full, optim.adam_init(full),
                                   DensifyStats.zeros(full.capacity, dev))
    del full
    bf = shard_field(scene.bfield, me, ndev)
    bo, bs = optim.adam_init(bf), DensifyStats.zeros(bf.capacity, dev)
    ident = BoxDeltas(**{k: v[None] for k, v in
                         BoxDeltas.identity(dev).as_dict().items()})
    deltas = {f: (ident, optim.tensor_adam_init(ident.as_dict()))
              for f in range(len(scene.noisy_b2w))}
    active = torch.ones(1, dtype=torch.bool, device=dev)
    bg = torch.zeros(3, device=dev)
    cam0 = scene.inputs(scene.train_cams[0], dev)[4]
    adapter = None
    raster = RasterizeConfig(k_cap=spec["k_cap"])
    if spec.get("adapter"):
        k0, floor, window = spec["adapter"]
        raster = raster._replace(k_cap=k0)
        adapter = AdapterLog(KCapAdapter(k0, k_cap_min=floor,
                                         decay_window=window),
                             spec.get("swap"))

    def build(rcfg):
        return make_tp_full_train_step(
            mesh, cfg, rcfg, SPATIAL, cam0, use_normal_loss=True,
            n_box_slots=1, box_lr_mult=BOX_LR_MULT, boxmodel_lr=BOXMODEL_LR,
            boxmodel_lambda_reg=BOXMODEL_LAMBDA_REG)

    tp = build(raster)
    step, t0 = 0, time.perf_counter()
    launches = _StepLaunches()
    trend, losses, step_ms, dropped_at, masks, events = [], [], [], [], [], []
    rebuilds = []

    def flat_deltas():
        return {f: BoxDeltas(**{k: v[0] for k, v in d.as_dict().items()})
                for f, (d, _) in deltas.items()}

    def evaluate_at(it):
        # every rank takes part in the gathers; rank 0 evaluates
        whole, bwhole = gather_field(sf, comm), gather_field(bf, comm)
        if me == 0:
            p = evaluate(scene, whole, bwhole, flat_deltas())
            trend.append({"it": it, "psnr": p,
                          "n": int(whole.num_active())})
            log(f"[tp seed {seed}] it {it}: psnr {p:.4f} n {trend[-1]['n']} "
                f"({time.perf_counter() - t0:.1f} s)")

    every = spec.get("every")
    evaluate_at(0)
    for it, c in enumerate(camera_order(scene, seed, iters), start=1):
        f, gt, normal, b2w, cam = scene.inputs(c, dev)
        d, dopt = deltas[f]
        ts = time.perf_counter()
        with launches:
            (sf, so, ss, step, (bf,), (bo,), (bs,), d, dopt, met) = tp(
                sf, so, ss, step, [bf], [bo], [bs], d, dopt, b2w, active,
                cam, gt, normal, 1.0, 3, bg)
            loss = float(met["loss"])
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if not np.isfinite(loss):
            raise FloatingPointError(f"[tp seed {seed}] rank {me} it {it}: "
                                     f"{met}")
        losses.append(loss)
        deltas[f] = (d, dopt)
        dropped, needed = _agreed(comm, met["num_dropped"], met["num_needed"])
        dropped_at.append(dropped)
        last.update(cam=cam, gt=gt, normal=normal, b2w=b2w, deltas=d,
                    raster=raster)
        if adapter is not None:
            new = adapter.observe(it, dropped, needed)
            if new is not None:
                raster = raster._replace(k_cap=new)
                tp = build(raster)
                rebuilds.append(it)
                log(f"[tp seed {seed}] it {it}: {adapter.events[-1][1]} -> "
                    f"k_cap {new} (dropped {dropped}, needed {needed})")
        if densify_at(it, spec["densify"]):
            if spec.get("masks"):
                rep = mask_report(comm, sf, ss, cfg)
                masks.append({"it": it, **rep})
                log(f"[tp seed {seed}] it {it}: masks {rep}")
            g = torch.Generator(device=dev).manual_seed(
                _split_seed(seed, it) * ndev + me)
            sf, so, ss, n = tp_densify_and_prune(
                mesh, sf, so, ss, g,
                grad_threshold=cfg.densify_grad_threshold,
                percent_dense=cfg.percent_dense, extent=SPATIAL,
                noise=_noise(spec.get("noise"), it, me))
            events.append({"it": it, "n": int(n), "capacity": sf.capacity})
        if (every and it % every == 0) or it == iters:
            evaluate_at(it)
    last.update(field=sf, opt=so, bfield=bf, box_opt=bo,
                deltas_by_frame=deltas)
    rec = {"rank": me, "losses": losses, "densify": events, "masks": masks,
           "adapter_events": adapter.events if adapter else [],
           "rebuilds": rebuilds, "dropped": dropped_at,
           "ms_per_step_median": statistics.median(step_ms),
           "wall_s": time.perf_counter() - t0,
           "step_launches": launches.total, "k_cap_final": raster.k_cap,
           "capacity": sf.capacity}
    if me == 0:
        err, raw = box_errors(scene, flat_deltas())
        rec.update(trend=trend, final_psnr=trend[-1]["psnr"], box_err=err,
                   box_err_raw=raw, n_active=trend[-1]["n"])
    return rec


def kcap_for(n_active: int) -> int:
    """quality_tp.py:90: ~2 instances a Gaussian at this scale, 3x margin,
    4096-aligned, at least 8192."""
    return max(8192, -(-3 * n_active // 4096) * 4096)


def _tp_static_loop(mesh, scene: Oracle, spec: dict, dev, log,
                    last: dict) -> dict:
    """The r02 run in this rank (quality_tp.py:86-160): the static TP step
    at SH degree 0 (min(it // 1000, 3)), zero normals and background,
    cameras from default_rng(3), densify at from < it <= until with split
    draws from one generator seeded 11, the step rebuilt when kcap_for's
    capacity changes, an evaluation at 0 and every `every`."""
    from .. import optim
    from ..gaussians import DensifyStats
    from ..ops.rasterize import RasterizeConfig
    from ..parallel.tp_trainer import (make_tp_train_step, shard_train_state,
                                       tp_densify_and_prune)

    comm = mesh.comm()
    me, ndev = comm.index, comm.size
    cfg = opt_config()
    full = _clone(scene.field)
    sf, so, ss = shard_train_state(mesh, full, optim.adam_init(full),
                                   DensifyStats.zeros(full.capacity, dev))
    n0 = int(full.num_active())
    del full
    cam0 = scene.inputs(scene.train_cams[0], dev)[4]
    bg = torch.zeros(3, device=dev)

    def build(n):
        rcfg = RasterizeConfig(k_cap=kcap_for(n))
        return rcfg, make_tp_train_step(mesh, cfg, rcfg, SPATIAL, cam0)

    raster, tp = build(n0)
    g = torch.Generator(device=dev).manual_seed(STATIC_KEY * ndev + me)
    host = np.random.default_rng(STATIC_CAM_SEED)
    launches = _StepLaunches()
    trend, losses, step_ms, events, dropped_at = [], [], [], [], []
    t0, step = time.perf_counter(), 0

    def evaluate_at(it):
        whole = gather_field(sf, comm)
        if me == 0:
            p = evaluate(scene, whole, k_cap=STATIC_EVAL_K_CAP)
            trend.append({"it": it, "psnr": p, "n": int(whole.num_active())})
            log(f"[static tp] it {it}: psnr {p:.4f} n {trend[-1]['n']} "
                f"({time.perf_counter() - t0:.1f} s)")

    evaluate_at(0)
    for it in range(1, spec["iters"] + 1):
        c = scene.train_cams[int(host.integers(len(scene.train_cams)))]
        _, gt, normal, _, cam = scene.inputs(c, dev)
        ts = time.perf_counter()
        with launches:
            sf, so, ss, step, met = tp(sf, so, ss, step, cam, gt, normal,
                                       min(it // 1000, 3), bg)
            loss = float(met["loss"])
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if not np.isfinite(loss):
            raise FloatingPointError(f"[static tp] rank {me} it {it}: {met}")
        losses.append(loss)
        dropped_at.append(_agreed(comm, met["num_dropped"],
                                  met["num_needed"])[0])
        last.update(cam=cam, gt=gt, normal=normal, raster=raster)
        if densify_at(it, spec["densify"], strict_from=True):
            sf, so, ss, n = tp_densify_and_prune(
                mesh, sf, so, ss, g, grad_threshold=cfg.densify_grad_threshold,
                percent_dense=cfg.percent_dense, extent=SPATIAL)
            if kcap_for(n) != raster.k_cap:
                raster, tp = build(n)
            events.append({"it": it, "n": int(n), "capacity": sf.capacity,
                           "k_cap": raster.k_cap})
        if it % spec["every"] == 0:
            evaluate_at(it)
    last.update(field=sf, bfield=None)
    rec = {"rank": me, "losses": losses, "densify": events,
           "dropped": dropped_at,
           "ms_per_step_median": statistics.median(step_ms),
           "wall_s": time.perf_counter() - t0,
           "step_launches": launches.total, "k_cap_final": raster.k_cap}
    if me == 0:
        rec.update(trend=trend, final_psnr=trend[-1]["psnr"])
    return rec


def _tp_rank(rank: int, specs: list, device_type: str, after=None) -> list:
    """The body of one rank of `run_tp`: each spec's run in turn, on card
    rank % cards (every rank on card 0 with one card), or the CPU. `after`
    (a module-level function, so the spawned rank can import it) is called
    after each run with (mesh, scene, spec, last) -- `last` holds the last
    step's camera, ground truth, normal, box pose and residuals, raster
    config and the final sharded fields -- and its return joins the run's
    record."""
    from ..parallel.tile_sharded import make_tile_mesh

    import torch.distributed as dist

    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device(device_type)
    mesh = make_tile_mesh(dist.get_world_size())
    log = ((lambda m: print(m, flush=True)) if rank == 0
           else (lambda m: None))
    out = []
    for spec in specs:
        static = spec["kind"] == "static"
        if static:
            scene = build_static_scene(np.random.default_rng(STATIC_SEED),
                                       device=dev)
        else:
            scene = build_scene(np.random.default_rng(SCENE_SEED),
                                device=dev)
        last = {}
        loop = _tp_static_loop if static else _tp_full_loop
        rec = loop(mesh, scene, spec, dev, log, last)
        if after is not None:
            rec["after"] = after(mesh, scene, spec, last)
        out.append(rec)
        del scene, last
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_tp(specs: list, *, ndev: int = NDEV, device=None, after=None,
           threads: Optional[int] = None) -> list:
    """The TP runs of `specs` in `ndev` ranks (`launch.spawn`, a `file://`
    rendezvous in a temporary directory); on the card every rank holds its
    own CUDA context, on one card all share it (gloo-host). Each run's
    record: rank 0's, with every rank's adapter events, rebuild
    iterations, step launches and ms (`ranks`). A rank that fails fails
    the call. Raises if the ranks took different adapter decisions."""
    from ..parallel import launch

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch.spawn(_tp_rank, ndev, specs, dev.type, after,
                             backend="gloo", init_file=Path(tmp) / "rdv",
                             threads=threads)
    out = []
    for i, spec in enumerate(specs):
        per = [r[i] for r in ranks]
        first = per[0]
        for key in ("adapter_events", "rebuilds", "densify", "masks"):
            if any(p.get(key) != first.get(key) for p in per):
                raise AssertionError(f"ranks disagree on {key}: "
                                     f"{[p.get(key) for p in per]}")
        rec = {k: v for k, v in first.items() if k != "rank"}
        rec["ranks"] = [{"rank": p["rank"],
                         "adapter_events": p.get("adapter_events", []),
                         "rebuilds": p.get("rebuilds", []),
                         "step_launches": p["step_launches"],
                         "ms_per_step_median": p["ms_per_step_median"],
                         "capacity": p.get("capacity"),
                         **({"after": p["after"]} if "after" in p else {})}
                        for p in per]
        rec.pop("after", None)
        rec["ndev"] = ndev
        out.append(rec)
    return out


# -- the runs -----------------------------------------------------------------


def _public(rec: dict) -> dict:
    """A single-device record without its live tensors."""
    return {k: v for k, v in rec.items()
            if k not in ("state", "box_field", "deltas")}


def run_seeds(device=None, log=print) -> dict:
    """QUALITY_TP_r05: the single-device arm at each seed first (their
    spread sets the band), then the TP runs in one spawn; seed 0's TP run
    with the live adapter (2^15, floor 512, window 30) and the mask report
    at each densify event."""
    dev = resolve_device(device)
    scene = build_scene(np.random.default_rng(SCENE_SEED), device=dev)
    single = {str(s): _public(run_single(scene, seed=s, log=log))
              for s in SEEDS}
    finals = [single[str(s)]["final_psnr"] for s in SEEDS]
    std = float(np.std(finals, ddof=1))
    log(f"[seeds] single finals {finals}: std {std}, band {psnr_band(std)}")
    specs = [{"kind": "full", "seed": s, "iters": R05_ITERS,
              "every": R05_EVERY, "densify": R05_DENSIFY, "k_cap": K_CAP,
              "adapter": R05_ADAPTER if s == SEEDS[0] else None,
              "masks": s == SEEDS[0]} for s in SEEDS]
    runs = {str(s): {"single": single[str(s)], "tp": t}
            for s, t in zip(SEEDS, run_tp(specs, device=dev))}
    diffs = [r["tp"]["final_psnr"] - r["single"]["final_psnr"]
             for r in runs.values()]
    return {"setting": _setting(R05_ITERS, dev), "runs": runs,
            "single_finals": finals, "std": std, "band": psnr_band(std),
            "tp_minus_single": diffs}


def run_full(device=None, log=print) -> dict:
    """QUALITY_TP_r04: single against TP at seed 0, an evaluation every
    50, densify [100, 400] every 100."""
    dev = resolve_device(device)
    scene = build_scene(np.random.default_rng(SCENE_SEED), device=dev)
    single = _public(run_single(scene, iters=R04_ITERS, every=R04_EVERY,
                                densify=R04_DENSIFY, log=log))
    (tp,) = run_tp([{"kind": "full", "seed": 0, "iters": R04_ITERS,
                     "every": R04_EVERY, "densify": R04_DENSIFY,
                     "k_cap": K_CAP}], device=dev)
    return {"setting": _setting(R04_ITERS, dev), "single": single, "tp": tp}


def run_static(device=None, log=print) -> dict:
    """QUALITY_TP_r02: the static TP trend."""
    dev = resolve_device(device)
    (tp,) = run_tp([{"kind": "static", "iters": STATIC_ITERS,
                     "every": STATIC_EVERY, "densify": STATIC_DENSIFY}],
                   device=dev)
    return {"setting": _setting(STATIC_ITERS, dev, STATIC_HW), "tp": tp}


def run_adapter(device=None, log=print) -> dict:
    """QUALITY_TP_r05b: the TP run from k_cap 1024 (floor 512, window 25),
    a stale cap swapped in at R05B_SWAP; no densify, an evaluation at 0
    and at the end. The threshold is OptimizationParams' default, as in
    the JAX demo (it never densifies)."""
    from ..config import OptimizationParams

    dev = resolve_device(device)
    (tp,) = run_tp([{"kind": "full", "seed": 0, "iters": R05B_ITERS,
                     "every": None, "densify": None, "k_cap": K_CAP,
                     "adapter": R05B_ADAPTER, "swap": R05B_SWAP,
                     "grad_threshold":
                     OptimizationParams().densify_grad_threshold}],
                   device=dev)
    return {"setting": {**_setting(R05B_ITERS, dev),
                        "swap": list(R05B_SWAP)}, "tp": tp}


def _setting(iters: int, dev, hw=(H, W)) -> dict:
    return {"hw": list(hw), "cams": N_CAMS, "iters": iters, "ndev": NDEV,
            **_card(dev)}


# -- holding the readings -----------------------------------------------------


def adapter_order_ok(events, dropped) -> tuple:
    """(kinds in the order grow+, stale-resume, decay+; no step dropped
    instances after the last grow)."""
    kinds = [k for _, k, _ in events]
    order = ("grow", "stale-resume", "decay")
    idx = [order.index(k) for k in kinds]
    ordered = bool(idx) and idx == sorted(idx) and set(idx) == {0, 1, 2}
    grows = [it for it, k, _ in events if k == "grow"]
    clean = bool(grows) and not any(dropped[grows[-1]:])
    return ordered, clean


def ranks_agree(rec: dict) -> bool:
    ranks = rec["ranks"]
    return all(r["rebuilds"] == ranks[0]["rebuilds"]
               and r["adapter_events"] == ranks[0]["adapter_events"]
               for r in ranks)


def step_launches_ok(rec: dict) -> bool:
    """Each rank's TP steps launched K1, K2 and K3, and no K4 (the sharded
    paths run no sat cull), M1 or M2."""
    return all(all(r["step_launches"][k] >= 1 for k in ("K1", "K2", "K3"))
               and not any(r["step_launches"].get(k, 0)
                           for k in ("K4", "M1", "M2"))
               for r in rec["ranks"])


def held(records: dict) -> list:
    """(what, port reading, reference, limit, within) of every held reading
    in `records`; the reference is the JAX reading, or the held target."""
    band = PSNR_BAND_DB
    rows = []
    seeds = records.get("seeds")
    if seeds:
        runs = seeds["runs"]
        s0 = runs.get("0")
        if s0:
            masks = s0["tp"]["masks"]
            total = sum(sum(m["diffs"]) for m in masks)
            rows.append((f"seed 0 differing rows, global vs shard-local, at "
                         f"its {len(masks)} densify events", total, 0, 0,
                         bool(masks) and total == 0))
            raw = s0["single"]["box_err_raw"]
            rows.append(("raw box-pose error (m)", raw, JAX_BOX_ERR_RAW,
                         BOX_ERR_TOL, within(raw, JAX_BOX_ERR_RAW,
                                             BOX_ERR_TOL)))
            ev = s0["tp"]["adapter_events"]
            ok = bool(ev) and all(k == "decay" for _, k, _ in ev)
            rows.append(("seed 0 adapter: decays only "
                         f"({', '.join(f'{i} {k} {n}' for i, k, n in ev)})",
                         len(ev), len(JAX_R05_ADAPTER), "decays only", ok))
            rows.append(("seed 0 adapter: every rank rebuilds at the same "
                         "iteration", s0["tp"]["rebuilds"],
                         [i for i, _, _ in JAX_R05_ADAPTER], "equal",
                         ranks_agree(s0["tp"])))
        for s, r in runs.items():
            i = int(s)
            for arm in ("single", "tp"):
                p, ref = r[arm]["final_psnr"], JAX_R05[arm][i]
                rows.append((f"seed {s} {arm} final PSNR", p, ref, band,
                             within(p, ref, band)))
            rows.append((f"seed {s} TP steps launch K1-K3, no K4",
                         r["tp"]["ranks"][0]["step_launches"], "-",
                         "K1-K3 >= 1, K4 M1 M2 0", step_launches_ok(r["tp"])))
        diffs = [r["tp"]["final_psnr"] - r["single"]["final_psnr"]
                 for r in runs.values()]
        jd = [t - s for s, t in zip(*JAX_R05.values())]
        m = float(np.mean(diffs))
        rows.append(("mean over seeds of TP - single (dB)", m,
                     float(np.mean(jd)), band, within(m, 0.0, band)))
    full = records.get("full")
    if full:
        for arm in ("single", "tp"):
            p, ref = full[arm]["final_psnr"], JAX_R04[arm][max(JAX_R04[arm])]
            rows.append((f"r04 {arm} final PSNR", p, ref, band,
                         within(p, ref, band)))
        rows.append(("r04 TP steps launch K1-K3, no K4",
                     full["tp"]["ranks"][0]["step_launches"], "-",
                     "K1-K3 >= 1, K4 M1 M2 0", step_launches_ok(full["tp"])))
    static = records.get("static")
    if static:
        last = static["tp"]["trend"][-1]
        ref = JAX_R02[max(JAX_R02)][0]
        rows.append((f"r02 final PSNR (it {last['it']})", last["psnr"], ref,
                     band, within(last["psnr"], ref, band)
                     and last["it"] == max(JAX_R02)))
        rows.append(("r02 TP steps launch K1-K3, no K4",
                     static["tp"]["ranks"][0]["step_launches"], "-",
                     "K1-K3 >= 1, K4 M1 M2 0", step_launches_ok(static["tp"])))
    adapter = records.get("adapter")
    if adapter:
        tp = adapter["tp"]
        ordered, clean = adapter_order_ok(tp["adapter_events"], tp["dropped"])
        ev = ", ".join(f"{i} {k} {n}" for i, k, n in tp["adapter_events"])
        rows.append((f"r05b events in the order grow, stale-resume, decay "
                     f"({ev})", len(tp["adapter_events"]), len(JAX_R05B),
                     "in order", ordered))
        grows = [i for i, k, _ in tp["adapter_events"] if k == "grow"]
        late = sum(1 for x in tp["dropped"][grows[-1]:] if x) if grows \
            else None
        rows.append(("r05b: steps that dropped instances after the last "
                     "grow", late, "-", 0, clean))
        rows.append(("r05b: every rank rebuilds at the same iteration",
                     tp["rebuilds"], [i for i, _, _ in JAX_R05B], "equal",
                     ranks_agree(tp)))
        rows.append(("r05b TP steps launch K1-K3, no K4",
                     tp["ranks"][0]["step_launches"], "-",
                     "K1-K3 >= 1, K4 M1 M2 0", step_launches_ok(tp)))
    return rows


# -- the report ---------------------------------------------------------------

_DATA = re.compile(r"<!-- quality-tp-records\n(.*)\n-->", re.S)


def read_records(path) -> dict:
    p = Path(path)
    if not p.exists():
        return {}
    m = _DATA.search(p.read_text())
    return json.loads(m.group(1)) if m else {}


def _fmt(x) -> str:
    if isinstance(x, float):
        return f"{x:.4f}"
    if isinstance(x, dict):
        return ", ".join(f"{k} {v}" for k, v in x.items())
    return str(x)


def _trend(rows) -> str:
    return ", ".join(f"it{r['it']}={r['psnr']:.2f}" for r in rows)


def _card_of(rec) -> str:
    s = rec.get("setting", rec)
    return s.get("card") or s.get("device", "?")


def _timing(rec) -> str:
    ms = [r["ms_per_step_median"] for r in rec["ranks"]] if "ranks" in rec \
        else [rec["ms_per_step_median"]]
    return (f"median ms a step {', '.join(f'{m:.1f}' for m in ms)}"
            + (" (ranks 0-%d)" % (len(ms) - 1) if len(ms) > 1 else "")
            + f", {rec['wall_s']:.1f} s wall")


def render_report(records: dict) -> str:
    """QUALITY_TORCH_TP.md from the runs' records."""
    L = ["# QUALITY_TORCH_TP — the fully sharded trainer's quality, port",
         "",
         "Written by `python -m vegs_torch.perf.quality_tp --run",
         "static|full|seeds|adapter`: the JAX package's TP quality harness",
         "(perf/quality_tp.py, quality_tp_full.py, quality_tp_r05.py,",
         "quality_tp_r05b_adapter.py) ported to `vegs_torch.perf.quality_tp`,",
         "the TP runs in D ranks started by `parallel.launch.spawn`",
         "(gloo; on one card every rank shares it and every collective is",
         "staged through the host, so no time here is a scaling reading),",
         "each reading beside the JAX package's recorded one (QUALITY_TP_r02,",
         "r04, r05 -- a 4-device virtual CPU mesh with the dense golden",
         "backend). Times are the card's named beside them.", ""]
    seeds = records.get("seeds")
    L += ["## The band", ""]
    if seeds:
        L += [f"The single-device arm at seeds "
              f"{', '.join(seeds['runs'])}: final held-out PSNR "
              + ", ".join(f"{p:.4f}" for p in seeds["single_finals"])
              + f" dB, sample standard deviation {seeds['std']:.4f} dB; "
              f"max(1 dB, 3 x std) = {seeds['band']:.3f} dB "
              f"({_card_of(seeds)}).", ""]
    L += [f"Fixed in `vegs_torch/perf/quality_tp.py` before any TP reading "
          f"was looked at: PSNR_BAND_DB = {PSNR_BAND_DB:.3f} "
          f"(std {SEED_PSNR_STD}).", ""]
    rows = held(records)
    if rows:
        L += ["## Held readings", "",
              "| reading | port | reference (JAX) | limit | within |",
              "|---|---|---|---|---|"]
        for what, got, ref, lim, ok in rows:
            L += [f"| {what} | {_fmt(got)} | {_fmt(ref)} | {_fmt(lim)} | "
                  f"{'yes' if ok else 'NO'} |"]
        L += [""]
    if seeds:
        s = seeds["setting"]
        L += ["## QUALITY_TP_r05's recipe: seeds 0-2", "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['cams']} cameras with the "
              f"mover, {s['iters']} iterations, densify [100, 260] every 80 "
              f"at tau 4e-4, k_cap 8192, D = {s['ndev']}; {_card_of(seeds)}.",
              "", "| seed | single PSNR | TP PSNR | TP - single | JAX single "
              "| JAX TP | box error single / TP (raw) |",
              "|---|---|---|---|---|---|---|"]
        for k, r in seeds["runs"].items():
            a, t = r["single"], r["tp"]
            L += [f"| {k} | {a['final_psnr']:.2f} | {t['final_psnr']:.2f} | "
                  f"{t['final_psnr'] - a['final_psnr']:+.2f} | "
                  f"{JAX_R05['single'][int(k)]:.2f} | "
                  f"{JAX_R05['tp'][int(k)]:.2f} | {a['box_err']:.3f} / "
                  f"{t['box_err']:.3f} ({a['box_err_raw']:.3f}) |"]
        L += ["", "Trends and timing:", ""]
        for k, r in seeds["runs"].items():
            L += [f"- seed {k} single: {_trend(r['single']['trend'])}; "
                  f"{_timing(r['single'])}",
                  f"  TP: {_trend(r['tp']['trend'])}; {_timing(r['tp'])}; "
                  f"step launches a rank "
                  + "; ".join(_fmt(x['step_launches'])
                              for x in r['tp']['ranks'])]
        s0 = seeds["runs"].get("0")
        if s0:
            L += ["", "### Global against shard-local densify masks (seed 0)",
                  "", "| iter | clone/split/prune counts | differing rows | "
                  "JAX counts | JAX differing |", "|---|---|---|---|---|"]
            for m in s0["tp"]["masks"]:
                jc, jd = JAX_R05_MASKS.get(m["it"], ("-", "-"))
                L += [f"| {m['it']} | {m['counts']} | {m['diffs']} | {jc} | "
                      f"{jd} |"]
            L += ["", "### The live adapter (seed 0's TP run)", "",
                  "| iter | event | new k_cap | JAX |", "|---|---|---|---|"]
            jax_ev = {i: f"{k} {n}" for i, k, n in JAX_R05_ADAPTER}
            for i, k, n in s0["tp"]["adapter_events"]:
                L += [f"| {i} | {k} | {n} | {jax_ev.get(i, '-')} |"]
            L += ["", "Rebuild iterations by rank: " + "; ".join(
                f"rank {x['rank']} {x['rebuilds']}"
                for x in s0["tp"]["ranks"]), ""]
    full = records.get("full")
    if full:
        s = full["setting"]
        L += ["## QUALITY_TP_r04's recipe: the trend", "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['iters']} iterations, densify "
              f"[100, 400] every 100, D = {s['ndev']}; {_card_of(full)}.", "",
              "| iteration | port single | port TP | diff | JAX single | "
              "JAX TP |", "|---|---|---|---|---|---|"]
        tp_by = {r["it"]: r["psnr"] for r in full["tp"]["trend"]}
        for r in full["single"]["trend"]:
            t = tp_by.get(r["it"])
            L += [f"| {r['it']} | {r['psnr']:.2f} | "
                  + (f"{t:.2f} | {t - r['psnr']:+.2f}" if t is not None
                     else "- | -")
                  + f" | {JAX_R04['single'].get(r['it'], float('nan')):.2f} | "
                  f"{JAX_R04['tp'].get(r['it'], float('nan')):.2f} |"]
        L += ["", f"Box error single {full['single']['box_err']:.3f} m, TP "
              f"{full['tp']['box_err']:.3f} m (raw "
              f"{full['single']['box_err_raw']:.3f} m; JAX 0.109 / 0.109 / "
              "0.109).", "",
              f"Timing: single {_timing(full['single'])}; TP "
              f"{_timing(full['tp'])}.", ""]
    static = records.get("static")
    if static:
        s, tp = static["setting"], static["tp"]
        L += ["## QUALITY_TP_r02's recipe: the static TP trend", "",
              f"{s['hw'][0]}x{s['hw'][1]}, no mover, {s['iters']} "
              f"iterations, densify at 100 and 150, k_cap by kcap_for, "
              f"D = {s['ndev']}; {_card_of(static)}.", "",
              "| iteration | port PSNR | port Gaussians | JAX PSNR | JAX "
              "Gaussians |", "|---|---|---|---|---|"]
        for r in tp["trend"]:
            jp, jn = JAX_R02.get(r["it"], (float("nan"), "-"))
            L += [f"| {r['it']} | {r['psnr']:.2f} | {r['n']} | {jp:.2f} | "
                  f"{jn} |"]
        L += ["", f"Densify events: {tp['densify']}. Timing: "
              f"{_timing(tp)}.", ""]
    adapter = records.get("adapter")
    if adapter:
        tp = adapter["tp"]
        L += ["## QUALITY_TP_r05b's demo: grow, stale resume, decay", "",
              f"From k_cap 1024 (floor 512, window 25), a stale 32768 at it "
              f"{adapter['setting']['swap'][0]}, {adapter['setting']['iters']}"
              f" iterations, D = {adapter['setting']['ndev']}; "
              f"{_card_of(adapter)}.", "",
              "| iter | event | new k_cap | JAX |", "|---|---|---|---|"]
        jax_ev = {i: f"{k} {n}" for i, k, n in JAX_R05B}
        for i, k, n in tp["adapter_events"]:
            L += [f"| {i} | {k} | {n} | {jax_ev.get(i, '-')} |"]
        L += ["", "Rebuild iterations by rank: " + "; ".join(
            f"rank {x['rank']} {x['rebuilds']}" for x in tp["ranks"]),
            f"Steps that dropped instances: "
            f"{[i + 1 for i, x in enumerate(tp['dropped']) if x]}.",
            f"Timing: {_timing(tp)}.", ""]
    L += ["<!-- quality-tp-records", json.dumps(records), "-->", ""]
    return "\n".join(L)


def write_report(path, run: str, record: dict) -> dict:
    records = read_records(path)
    records[run] = record
    Path(path).write_text(render_report(records))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True,
                    choices=("static", "full", "seeds", "adapter"))
    ap.add_argument("--out", default=str(REPORT))
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, flush=True)

    rec = {"static": run_static, "full": run_full, "seeds": run_seeds,
           "adapter": run_adapter}[args.run](device=dev, log=log)
    records = write_report(args.out, args.run, rec)
    rows = held(records)
    for r in rows:
        log(json.dumps({"held": r[0], "port": r[1], "jax": r[2],
                        "limit": r[3], "within": r[4]}, default=str))
    log(f"wrote {args.out}")
    return 1 if any(ok is False for *_, ok in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
