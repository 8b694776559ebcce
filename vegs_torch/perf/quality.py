"""End-to-end quality runs on the ray-traced street oracle: port of the JAX
package's quality harness (perf/quality_full.py, quality_r02.py,
quality_full_r04.py, quality_full_r05.py, quality_box_r05.py).

The oracle (`utils.synthetic`) ray-traces a checkerboard street with
lambertian boxes and a sky, and one "vehicle" box crossing it; the ground
truth shares no code with the Gaussian rasterizer. Training starts from a
seeded noisy surface sampling. Four runs, each held against the reading
the JAX package recorded for the same recipe:

- `static`: the round-2 recipe (64x128, 17 cameras, 1,000 iterations,
  densify [100, 700] every 100 at tau 0.0004, k_cap 2^14), against
  QUALITY_r02 (reported beside, not held: that run predates later fixes);
- `full`: arms A-E at 128x256, 17 cameras, 1,500 iterations, densify
  [100, 900] every 100 at tau 0.0002, k_cap 2^17 with the adapter free:
  A static-only (the mover stripped), B + the normal-prior init, C + the
  normal-guidance loss (lambda_dnormal 1e-3), D + the mover and its box
  model, E + the VGG perceptual term (0.01) with a trunk to 0.75 x ITERS
  and two branches from one snapshot, score-matching guidance by a tiny
  SD stack pretrained on the scene's crops (`pretrain_unet`,
  `pretrain_vae`) against none, each evaluated on the held-out views and
  on the test views yawed +-18 degrees (`make_aug_cameras`); held against
  QUALITY_FULL_r05;
- `box`: stereo box-pose recovery (5 frames x 2 eyes at a 0.54 m baseline,
  0.125 m injected noise, lambda_reg 1e-3, 1,400 iterations), against
  QUALITY_BOX_r05;
- `seeds`: arm A at Trainer seeds 3, 4 and 5; the spread of their final
  held-out PSNR sets the band every PSNR is held by (`PSNR_BAND_DB`).

Every run trains through the port's Trainer, so on the card each step
launches K1-K3 (and K4 while the sat-cull gate is on); each run records
its launches, ms per step and k_cap's path.

Three superseded runs reuse that scene, recipe and evaluation; their
readings go into the same report:

- `run_r03` (quality_full.py:179-247): 64x128, 17 cameras, 1,000
  iterations, the mover with 0.08 m of annotation noise, normal-prior
  init, VGG perceptual term 0.01, the tiny SD stack with random weights
  (generator seed 0) guiding in the window [750, 1000]
  (score-matching, max_step 50), k_cap 2^14; every 100 iterations the
  held-out PSNR and SSIM with the box composited, the active Gaussians and
  the box's mean translation error.
- `run_r04` (quality_full_r04.py:207-325): 128x256, 17 cameras, the tiny
  UNet pretrained on the training images' crops (1,500 steps), a trunk
  to 0.6 x the iterations, then two branches from one snapshot to the
  end, guided (sm_lambda 3e-7) and unguided, each evaluated every 200
  iterations on the held-out views and on the test views yawed by +-18
  degrees. The script's default is 2,000 iterations (a trunk to 1,200);
  the run QUALITY_FULL_r04.md records ran 1,400 (a trunk to 840, densify
  until 840) and so does this one, so its readings stand beside the
  recorded ones iteration for iteration.
- `run_box_r04` (quality_box.py:40-123): 128x256, 9 cameras, one eye,
  0.125 m of noise, 1,200 iterations, no guidance or perceptual term, a
  sweep of boxmodel_lambda_reg over [1e-3, 1e-4]; every 100 iterations the
  mean translation error and the held-out PSNR (`run_box`).

The JAX readings (QUALITY_FULL_r03.md, QUALITY_FULL_r04.md,
QUALITY_BOX_r04.md) predate fixes the port carries: r03's the box-delta
`safe_norm` fix (34c0164; quality_box.py:6-8: its deltas never left
identity, so its error column is frozen at 0.123 m) and the SSIM gradient
fix (b15ede2: float32 filters and clamped variances); r04's and
box_r04's the SSIM gradient fix, whose absence held the JAX runs at
128x256 near 7 dB. They are reported beside the port's, not held within a
band. r03's final held-out PSNR is held twice: one-sided, at or above
JAX's less `PSNR_BAND_DB`, and two-sided, within `PSNR_BAND_DB` of the
port's own first card reading (`PORT_R03_FINAL`), so that a fault costing
more than the band shows although the port is far above JAX; its
untrained reading at iteration 0 is the control that must miss both.

Run on the card:  python -m vegs_torch.perf.quality
                  --run static|full|box|seeds|r03|r04|box_r04 [--out PATH]
The CLI writes only its report, QUALITY_TORCH.md at the repository's root
(or --out): each run's record is kept in the file (a JSON block at its
end), so runs made in separate calls collect in one report. It exits 1
when a held reading misses its band. Functions take `device="cpu"` for
the CPU tests; without it they run on the card.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from . import launch_counts, main_counters

ROOT = Path(__file__).resolve().parents[2]
REPORT = ROOT / "QUALITY_TORCH.md"

# -- the runs' settings (the JAX scripts' defaults, or the setting its
# recorded report ran at) -----------------------------------------------------
H, W, N_CAMS = 128, 256, 17
ITERS = 1500
EVAL_EVERY = 300
BOX_NOISE_T = 0.08            # quality_full.py's annotation noise (m)
SCENE_SEED = 7                # numpy seed of the scene (all runs but static)
TRAIN_SEED = 3                # the Trainer's rng_seed
SEEDS = (3, 4, 5)
FULL_K_CAP = 1 << 17
PRETRAIN_STEPS = 1200
SD_IMAGE_SIZE = 32
AUG_YAW_DEG = 18.0

STATIC_HW, STATIC_ITERS, STATIC_EVERY, STATIC_K_CAP = (64, 128), 1000, 100, 1 << 14

BOX_FRAMES, BOX_ITERS, BOX_EVERY = 5, 1400, 200
BOX_BASELINE, BOX_NOISE, BOX_LAMBDA_REG, BOX_K_CAP = 0.54, 0.125, 1e-3, 1 << 14
# quality_full.py's guidance window (its 1,000-iteration default); the box
# run trains without guidance, the window is kept so the configs compare
BOX_GUIDE = (750, 1000)

ARMS = {  # arm: (with the mover, normal init, lambda_dnormal, perceptual)
    "A": (False, False, 0.0, False),
    "B": (False, True, 0.0, False),
    "C": (False, True, 1e-3, False),
    "D": (True, True, 1e-3, False),
    "E": (True, True, 1e-3, True),
}
ARM_NAMES = {"A": "static-only", "B": "+ normal-prior init",
             "C": "+ normal-guidance loss", "D": "+ boxes (mover scene)",
             "E": "full (D + perceptual; unguided branch)"}

# -- the JAX package's recorded readings ----------------------------------------
# QUALITY_FULL_r05.md: each arm's final held-out PSNR (dB) and SSIM, and
# its trend; E's branches (test, extrapolated) and guided iterations
JAX_FULL = {"A": (28.40, 0.903), "B": (29.43, 0.947), "C": (29.33, 0.946),
            "D": (30.29, 0.951), "E": (30.39, 0.952)}
JAX_FULL_TREND = {
    "A": "it0=6.13, it300=18.35, it600=25.73, it900=27.04, it1200=28.35, "
         "it1500=28.40",
    "B": "it0=5.29, it300=9.35, it600=22.21, it900=28.02, it1200=29.24, "
         "it1500=29.43",
    "C": "it0=5.29, it300=9.21, it600=20.90, it900=28.20, it1200=29.43, "
         "it1500=29.33",
    "D": "it0=5.30, it300=9.22, it600=18.37, it900=28.89, it1200=30.33, "
         "it1500=30.29",
    "E": "it0=5.30, it300=9.23, it600=18.31, it900=28.97, it1125=30.16, "
         "it1500=30.39"}
JAX_A_IT900 = 27.04
JAX_BRANCH = {"guided": (30.64, 15.48), "unguided": (30.39, 15.44),
              "guided_iters": 374}
JAX_PRETRAIN = {"unet": (1.403, 0.083), "vae": (0.9817, 0.0091)}
SSIM_BAND = 0.02
# E's guided iterations are held at 375 +- 1 (the window's 374 interior
# iterations, as JAX counted, or one more at either end)
GUIDED_ITERS, GUIDED_ITERS_BAND = 375, 1
# QUALITY_BOX_r05.md: the stereo run's test PSNR, raw and final mean
# translation error (m), the share recovered
JAX_BOX = {"psnr": 32.1, "err_raw": 0.1607, "err_final": 0.1281,
           "recovered": 0.20}
# QUALITY_r02.md: held-out PSNR by iteration (64x128, 1,000 iterations)
JAX_STATIC = {0: 6.22, 100: 10.74, 200: 12.19, 300: 15.84, 400: 18.58,
              500: 20.82, 600: 21.44, 700: 20.82, 800: 21.06, 900: 21.28,
              1000: 21.32}



def psnr_band(std: float) -> float:
    """The band every held PSNR lies in: max(1 dB, 3 x the sample
    standard deviation of arm A's final held-out PSNR over SEEDS)."""
    return max(1.0, 3.0 * std)


# Set from the `seeds` run on the card before any arm was read
# (QUALITY_TORCH.md: an NVIDIA H100 80GB HBM3 at 700 W read 28.709,
# 28.555, 28.582 dB).
SEED_PSNR_STD = 0.08196552151632439
PSNR_BAND_DB = psnr_band(SEED_PSNR_STD)


# -- the scene ------------------------------------------------------------------


def build_scene_info(rng, h=H, w=W, n_cams=N_CAMS, noise_t=BOX_NOISE_T,
                     stereo_baseline=0.0):
    """The oracle scene (quality_full.py:61): `n_cams` street frames (two
    eyes each with a stereo baseline) ray-traced with the mover and normal
    maps, the reference's idx % 8 test split, `sample_scene_points(n_ground=
    3000, n_box=600)`, the mover's canonical points mapped to the world by
    its TRUE pose in every frame (its dynamic cloud), and its box-to-world
    per frame, true and with `noise_t` m of Gaussian translation noise (the
    annotations the Trainer gets). All draws from `rng` in the JAX
    function's order. Returns (SceneInfo, true {frame: [4, 4]}, noisy)."""
    from ..scene import dataset_readers as dr
    from ..utils import synthetic as syn

    infos = syn.street_camera_infos(
        n_cams, h, w, render_gt=True, moving_box=True, render_normal=True,
        stereo_baseline=stereo_baseline)
    train_infos = [c for i, c in enumerate(infos) if i % 8 != 0]
    test_infos = [c for i, c in enumerate(infos) if i % 8 == 0]
    pts, cols = syn.sample_scene_points(rng, n_ground=3000, n_box=600)
    pcd = dr.BasicPointCloud(pts, cols)
    canon, ccols = syn.mover_canonical_points(rng, n=420)
    true_b2w, noisy_b2w = {}, {}
    dyn_pts = []
    ones = np.ones((len(canon), 1), np.float32)
    for f in range(n_cams):
        m = syn.mover_box2world(f, n_cams)
        true_b2w[f] = m
        noise = np.eye(4, dtype=np.float32)
        noise[:3, 3] = rng.normal(0, noise_t, 3).astype(np.float32)
        noisy_b2w[f] = noise @ m
        dyn_pts.append((np.concatenate([canon, ones], 1) @ m.T)[:, :3])
    dyn = dr.DynamicPointCloud(
        points=np.concatenate(dyn_pts).astype(np.float32),
        colors=np.concatenate([ccols] * n_cams).astype(np.float32),
        instances=np.full(n_cams * len(canon), syn.MOVER_INSTANCE),
        timestamps=np.repeat(np.arange(n_cams), len(canon)))
    train_frames = {int(c.frame) for c in train_infos}
    info = dr.SceneInfo(
        point_cloud=pcd, train_cameras=train_infos, test_cameras=test_infos,
        nerf_normalization=dr.getNerfppNorm(infos, pcd), ply_path="",
        dyn_point_cloud=dyn,
        train_bboxes={f: {syn.MOVER_INSTANCE: noisy_b2w[f]}
                      for f in range(n_cams) if f in train_frames},
        test_bboxes={f: {syn.MOVER_INSTANCE: noisy_b2w[f]}
                     for f in range(n_cams) if f not in train_frames},
        instances_info=[syn.MOVER_INSTANCE])
    return info, true_b2w, noisy_b2w


def strip_boxes(info):
    """The scene without the mover's models (quality_full_r05.py:60); its
    images still show the mover."""
    return dataclasses.replace(info, dyn_point_cloud=None, train_bboxes={},
                               test_bboxes={}, instances_info=[])


def box_pose_errors(tr, true_b2w) -> tuple:
    """(mean translation error of the noisy annotation adjusted by the
    learned delta, of the raw annotation) against the true pose, over the
    train frames (quality_full.py:159)."""
    from .. import boxmodel
    from ..scene import box_matrix

    errs_adj, errs_raw = [], []
    for f, boxes in tr.scene.train_bboxes.items():
        inst = next(iter(boxes))
        noisy = box_matrix(boxes[inst]).astype(np.float32)
        d = tr.frame_deltas.get((f, inst))
        if d is None:
            adj = noisy
        else:
            adj = boxmodel.adjust_box2world(
                torch.from_numpy(noisy).to(d.delta_t.device),
                d).detach().cpu().numpy()
        errs_adj.append(np.linalg.norm(adj[:3, 3] - true_b2w[f][:3, 3]))
        errs_raw.append(np.linalg.norm(noisy[:3, 3] - true_b2w[f][:3, 3]))
    return float(np.mean(errs_adj)), float(np.mean(errs_raw))


# -- configs and Trainers ---------------------------------------------------------


def static_config():
    """quality_r02.py:49's overrides."""
    from ..config import VegsConfig

    cfg = VegsConfig()
    cfg.opt.densify_from_iter = 100
    cfg.opt.densification_interval = 100
    cfg.opt.densify_until_iter = 700
    cfg.opt.opacity_reset_interval = 10_000
    cfg.opt.densify_grad_threshold = 0.0004
    return cfg


def arm_config(arm: str, iters: int = ITERS):
    """quality_full_r05.py:70's overrides for `arm`: densify until 0.6 x
    `iters` at the reference's tau 0.0002, the guidance window closed (E's
    guided branch opens it)."""
    from ..config import VegsConfig

    _, _, lam_dnormal, perceptual = ARMS[arm]
    cfg = VegsConfig()
    cfg.opt.densify_from_iter = 100
    cfg.opt.densification_interval = 100
    cfg.opt.densify_until_iter = int(iters * 0.6)
    cfg.opt.opacity_reset_interval = 10_000
    cfg.opt.densify_grad_threshold = 0.0002
    cfg.opt.lambda_dnormal = lam_dnormal
    cfg.sd.perceptual_loss = perceptual
    cfg.sd.perceptual_loss_lambda = 0.01
    cfg.sd.sd_image_size = SD_IMAGE_SIZE
    cfg.sd.start_guiding_from_iter = 10 ** 9
    cfg.sd.end_guiding_at_iter = 10 ** 9
    return cfg


def box_config(lambda_reg: float = BOX_LAMBDA_REG):
    """quality_full.py:103's overrides as quality_box_r05.py:52 leaves
    them: no perceptual term, the box pull `lambda_reg`."""
    cfg = static_config()
    cfg.sd.perceptual_loss = False
    cfg.sd.perceptual_loss_lambda = 0.01
    cfg.sd.start_guiding_from_iter, cfg.sd.end_guiding_at_iter = BOX_GUIDE
    cfg.sd.sd_image_size = SD_IMAGE_SIZE
    cfg.sd.sm_lambda = 1e-7
    cfg.box.boxmodel_lambda_reg = lambda_reg
    return cfg


def build_trainer(info, cfg, *, k_cap: int, seed: int = TRAIN_SEED,
                  norminit: bool = False, device=None):
    """A Trainer on the scene `info` (cameras in order), with capacity
    `k_cap` and the normal-prior init when `norminit`."""
    from ..ops.rasterize import RasterizeConfig
    from ..scene import Scene
    from ..train import Trainer

    dev = resolve_device(device)
    scene = Scene(cfg.model, scene_info=info, shuffle=False, device=dev)
    tr = Trainer(cfg, scene, raster_cfg=RasterizeConfig(k_cap=k_cap),
                 rng_seed=seed, device=dev)
    if norminit:
        tr.init_from_normals()
    return tr


def arm_trainer(arm: str, info, *, iters: int = ITERS, seed: int = TRAIN_SEED,
                device=None):
    """Arm `arm`'s Trainer on the mover scene `info` (stripped for A-C)."""
    boxes, norminit, _, _ = ARMS[arm]
    return build_trainer(info if boxes else strip_boxes(info),
                         arm_config(arm, iters), k_cap=FULL_K_CAP, seed=seed,
                         norminit=norminit, device=device)


# -- trunk and branch --------------------------------------------------------------


def _clone(x):
    """A deep copy of Trainer state: tensors cloned, fields rebuilt."""
    from ..gaussians import GaussianField

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, GaussianField):
        from ..convert import FIELD_KEYS

        return GaussianField(**{k: _clone(getattr(x, k)) for k in FIELD_KEYS})
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


_BOX_STATE = ("box_fields", "box_opts", "box_stats", "frame_deltas",
              "frame_delta_opts")


def snapshot_trainer(tr) -> dict:
    """Everything a Trainer's next steps read and write, copied
    (quality_full_r04.py:130): the port updates the fields and Adam moments
    in place, so a snapshot of references would follow the branch. The
    static state (field, Adam, densify statistics, step), every box field,
    Adam state and statistics, each (frame, instance) residual and its Adam
    state, the host rng, both torch generators, the camera stack, the
    capacities and the adapter's streaks."""
    return {"state": _clone(tr.state),
            **{k: _clone(getattr(tr, k)) for k in _BOX_STATE},
            "rng": copy.deepcopy(tr.rng),
            "generator": tr.generator.get_state(),
            "guidance_generator": tr.guidance_generator.get_state(),
            "viewpoint_stack": list(tr.viewpoint_stack),
            "raster_cfg": tr.raster_cfg,
            "streaks": (getattr(tr, "_kcap_low_streak", 0),
                        getattr(tr, "_kpad_low_streak", 0))}


def restore_trainer(tr, snap: dict) -> None:
    """Put a `snapshot_trainer` state back (copied again, so one snapshot
    restores any number of times)."""
    tr.state = _clone(snap["state"])
    tr.scene.gaussians = tr.state.field
    for k in _BOX_STATE:
        setattr(tr, k, _clone(snap[k]))
    tr.rng = copy.deepcopy(snap["rng"])
    tr.generator.set_state(snap["generator"])
    tr.guidance_generator.set_state(snap["guidance_generator"])
    tr.viewpoint_stack = list(snap["viewpoint_stack"])
    tr.raster_cfg = snap["raster_cfg"]
    tr._kcap_low_streak, tr._kpad_low_streak = snap["streaks"]


# -- extrapolated views ---------------------------------------------------------------


def make_aug_cameras(test_cams, n_frames: int, yaw_deg: float = AUG_YAW_DEG):
    """Each test camera yawed by -yaw and +yaw about its own centre, ground
    truth ray-traced at the new pose with the mover of its frame
    (quality_full_r04.py:94; `n_frames` places the mover)."""
    from ..scene.cameras import Camera
    from ..scene.dataset_readers import fov2focal
    from ..utils import synthetic as syn

    out = []
    for c in test_cams:
        f = int(c.frame)
        h, w = c.image_height, c.image_width
        for sgn in (-1.0, 1.0):
            a = np.deg2rad(yaw_deg) * sgn
            ca, sa = np.cos(a), np.sin(a)
            Ry = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
            Rw2c = np.asarray(c.R).T
            C = -Rw2c.T @ np.asarray(c.T)
            Rw2c_aug = Ry @ Rw2c
            T_aug = (-Rw2c_aug @ C).astype(np.float32)
            img = syn.raytrace(Rw2c_aug.T, T_aug, h, w, c.FoVx, c.FoVy,
                               extra_boxes=[syn.mover_box(f, n_frames)])
            K = np.array([[fov2focal(c.FoVx, w), 0, w / 2],
                          [0, fov2focal(c.FoVy, h), h / 2],
                          [0, 0, 1.0]], np.float32)
            out.append(Camera(
                colmap_id=1000 + 10 * f + (0 if sgn < 0 else 1),
                R=Rw2c_aug.T.astype(np.float32), T=T_aug, FoVx=c.FoVx,
                FoVy=c.FoVy, K=K, image=img,
                image_name=f"aug_{f}_{sgn:+.0f}", frame=f))
    return out


# -- the tiny SD stack's per-scene pretraining ------------------------------------------


def _adamw(params, lr):
    # optax.adamw's defaults (the JAX scripts' optimizer)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _fit(module, loss_of, steps: int, lr: float, draws, draw, on_loss):
    """`steps` AdamW updates of every parameter of `module` on
    loss_of(draws of the step), at optax's cosine-decayed rate; the
    parameters' requires_grad flags are put back afterwards."""
    from ..diffusion.lora import cosine_lr

    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(True)
    opt = _adamw(params, lr)
    draws = iter(draws) if draws is not None else None
    try:
        for i in range(steps):
            d = next(draws) if draws is not None else draw()
            opt.zero_grad(set_to_none=True)
            loss = loss_of(d)
            loss.backward()
            for group in opt.param_groups:
                group["lr"] = cosine_lr(lr, i, steps)
            opt.step()
            on_loss(i, loss.detach())
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)
            p.grad = None


def pretrain_unet(models, images_chw, steps: int = PRETRAIN_STEPS,
                  batch: int = 8, crop: int = 32, lr: float = 2e-4,
                  seed: int = 0, draws=None):
    """Fit the whole tiny UNet, in place, with the epsilon-prediction MSE
    on random `crop` crops of the scene's images encoded by the frozen VAE
    (quality_full_r04.py:45): `steps` AdamW updates of `batch` crops.
    Draws from a generator seeded `seed` on the models' device, or the
    `lora.MicroBatchDraws` of `draws`, one per step. Returns (models, the
    loss at every 100th step and the last)."""
    from ..diffusion import lora

    dev = models.text_embeddings.device
    images = torch.as_tensor(np.asarray(images_chw), dtype=torch.float32,
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    f = models.vae.config.downsample_factor
    latent = (batch, models.vae.config.latent_channels, crop // f, crop // f)
    vae_flags = [p.requires_grad for p in models.vae.parameters()]
    models.vae.requires_grad_(False)
    losses = []

    def on_loss(i, loss):
        if i % 100 == 0 or i == steps - 1:
            losses.append(float(loss))

    try:
        _fit(models.unet,
             lambda d: lora.micro_batch_loss(
                 models, images, crop,
                 lora.MicroBatchDraws(*(x.to(dev) for x in d))),
             steps, lr, draws,
             lambda: lora.draw_micro_batch(
                 g, images.shape, crop, batch, latent,
                 models.schedule.num_train_timesteps), on_loss)
    finally:
        for p, fl in zip(models.vae.parameters(), vae_flags):
            p.requires_grad_(fl)
    return models, losses


def vae_loss(vae, crops, eps):
    """Reconstruction MSE + 1e-4 KL of [n, 3, h, w] crops in [0, 1], the
    latent sampled with `eps` (quality_full_r05.py:126)."""
    x = crops * 2.0 - 1.0
    mean, logvar = vae.encode_moments(x)
    z = mean + torch.exp(0.5 * logvar) * eps
    rec = vae.decode(z)
    kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return torch.mean((rec - x) ** 2) + 1e-4 * kl


def pretrain_vae(models, images_chw, steps: int = PRETRAIN_STEPS,
                 batch: int = 8, crop: int = 32, lr: float = 2e-4,
                 seed: int = 1, draws=None):
    """Fit the whole tiny VAE, in place, on random crops of the scene's
    images (`vae_loss`; quality_full_r05.py:103). Each step's crops and
    encoder eps are the `bi`, `ys`, `xs` and `eps` of a
    `lora.MicroBatchDraws` (from `draws`, or drawn from a generator seeded
    `seed`). Returns (models, (first loss, last loss))."""
    from ..diffusion import lora

    dev = models.text_embeddings.device
    images = torch.as_tensor(np.asarray(images_chw), dtype=torch.float32,
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    f = models.vae.config.downsample_factor
    latent = (batch, models.vae.config.latent_channels, crop // f, crop // f)
    first_last = [None, None]

    def loss_of(d):
        crops = lora.crop_at(images, d.bi, d.ys, d.xs, crop)
        return vae_loss(models.vae, crops, d.eps.to(dev))

    def on_loss(i, loss):
        if i == 0:
            first_last[0] = float(loss)
        if i == steps - 1:
            first_last[1] = float(loss)

    _fit(models.vae, loss_of, steps, lr, draws,
         lambda: lora.draw_micro_batch(g, images.shape, crop, batch, latent,
                                       models.schedule.num_train_timesteps),
         on_loss)
    return models, tuple(first_last)


# -- training with evaluations -------------------------------------------------------


def _launches() -> dict:
    return launch_counts(main_counters())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    """Iterations of one Trainer with its readings: evaluations (held-out
    PSNR and SSIM with the boxes composited, active Gaussians, and on
    `aug_cams` the extrapolated PSNR), the ms of every step (host clock; a
    step ends in a read of its metrics from the card), k_cap's path, the
    guided iterations, the kernels' launches, the last step's camera."""

    def __init__(self, label: str, tr, aug_cams=None, log=print):
        self.label, self.tr, self.aug_cams, self.log = label, tr, aug_cams, log
        self.trend, self.step_ms, self.guided = [], [], 0
        self.kcap = [(0, tr.raster_cfg.k_cap, tr.raster_cfg.k_pad)]
        self.t0 = time.perf_counter()
        self.launch0 = _launches()
        self.last_cam = None

    def evaluate(self, it: int, boxes: bool = True, ssim: bool = True) -> dict:
        tr = self.tr
        e = tr.evaluate(with_boxes=boxes, with_ssim=ssim)
        row = {"it": it, "psnr": e["psnr"],
               "n": int(tr.state.field.num_active())}
        if ssim:
            row["ssim"] = e["ssim"]
        if self.aug_cams is not None:
            a = tr.evaluate(cameras=self.aug_cams, with_boxes=boxes,
                            with_ssim=ssim)
            row["aug_psnr"] = a["psnr"]
            if ssim:
                row["aug_ssim"] = a["ssim"]
        self.trend.append(row)
        self.log(f"[{self.label}] " + json.dumps(row)
                 + f" ({time.perf_counter() - self.t0:.1f} s)")
        return row

    def step(self, it: int) -> dict:
        tr = self.tr
        dev = tr.device
        cam = tr._next_camera()
        t0 = time.perf_counter()
        m = tr.train_iteration(it, camera=cam)
        _sync(dev)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.last_cam = cam
        self.guided += "guidance_loss" in m
        if not np.isfinite(m["loss"]):
            raise FloatingPointError(f"[{self.label}] it {it}: loss {m}")
        k = (tr.raster_cfg.k_cap, tr.raster_cfg.k_pad)
        if k != self.kcap[-1][1:]:
            self.kcap.append((it, *k))
        return m

    def train(self, first: int, last: int, every: int, **eval_kw) -> None:
        """Iterations first..last, evaluating every `every` and at `last`."""
        for it in range(first, last + 1):
            self.step(it)
            if it % every == 0 or it == last:
                self.evaluate(it, **eval_kw)

    def record(self) -> dict:
        now = _launches()
        return {"trend": self.trend,
                "ms_per_step_median": (statistics.median(self.step_ms)
                                       if self.step_ms else None),
                "steps": len(self.step_ms),
                "wall_s": time.perf_counter() - self.t0,
                "kcap_path": self.kcap, "guided_iters": self.guided,
                "launches": {k: now[k] - self.launch0[k] for k in now}}


def train_arm(arm: str, info, *, iters: int = ITERS, seed: int = TRAIN_SEED,
              every: int = EVAL_EVERY, device=None, log=print):
    """Arm `arm` (not E) trained `iters` iterations, evaluated at 0, every
    `every` and at the end. Returns its `Run`."""
    tr = arm_trainer(arm, info, iters=iters, seed=seed, device=device)
    run = Run(f"{arm} seed {seed}", tr, log=log)
    run.evaluate(0)
    run.train(1, iters, every)
    return run


def _card(dev) -> dict:
    if dev.type != "cuda":
        return {"device": str(dev)}
    from .timing import card_line

    return {"device": torch.cuda.get_device_name(dev), "card": card_line()}


def arm_e(info, *, iters: int = ITERS, n_frames: int = N_CAMS,
          pretrain_steps: int = PRETRAIN_STEPS, device=None, log=print):
    """Arm E (quality_full_r05.py:270): the tiny SD stack (generator seed 0)
    pretrained on the training images, a trunk to 0.75 x `iters` evaluated
    on the held-out and extrapolated views, a snapshot, then the guided
    branch (score-matching, max_step 50, the window (0.75 x iters, iters))
    and the unguided branch from the same snapshot. Returns its record."""
    from ..diffusion.pipeline import DiffusionModels
    from ..losses.sd_guidance import SDGuidance

    dev = resolve_device(device)
    guide_from = int(iters * 0.75)
    tr = arm_trainer("E", info, iters=iters, device=dev)
    train_imgs = np.stack([np.asarray(c.image) for c in info.train_cameras])
    g = torch.Generator(device=dev).manual_seed(0)
    models = DiffusionModels.tiny(g, image_size=SD_IMAGE_SIZE)
    t0 = time.perf_counter()
    models, unet_losses = pretrain_unet(models, train_imgs,
                                        steps=pretrain_steps)
    models, vae_losses = pretrain_vae(models, train_imgs, steps=pretrain_steps)
    _sync(dev)
    pre_s = time.perf_counter() - t0
    log(f"[E] pretrain: unet {unet_losses[0]:.4f} -> {unet_losses[-1]:.4f}, "
        f"vae {vae_losses[0]:.4f} -> {vae_losses[1]:.4f} ({pre_s:.1f} s)")
    aug = make_aug_cameras(tr.scene.getTestCameras(), n_frames)
    trunk = Run("E-trunk", tr, aug_cams=aug, log=log)
    trunk.evaluate(0)
    trunk.train(1, guide_from, EVAL_EVERY)
    snap = snapshot_trainer(tr)

    tr.sd_guidance = SDGuidance(models, guidance_mode="score-matching",
                                start_iter=guide_from, max_iters=iters,
                                max_step=50)
    tr.cfg.sd.start_guiding_from_iter = guide_from
    tr.cfg.sd.end_guiding_at_iter = iters
    guided = Run("E-guided", tr, aug_cams=aug, log=log)
    guided.train(guide_from + 1, iters, iters)

    restore_trainer(tr, snap)
    tr.sd_guidance = None
    tr.cfg.sd.start_guiding_from_iter = 10 ** 9
    tr.cfg.sd.end_guiding_at_iter = 10 ** 9
    unguided = Run("E-unguided", tr, aug_cams=aug, log=log)
    unguided.train(guide_from + 1, iters, iters)
    return {"trunk": trunk.record(), "guided": guided.record(),
            "unguided": unguided.record(),
            "pretrain": {"unet": unet_losses, "vae": list(vae_losses),
                         "steps": pretrain_steps, "seconds": pre_s}}


def run_full(*, h=H, w=W, n_cams=N_CAMS, iters=ITERS,
             pretrain_steps=PRETRAIN_STEPS, device=None, log=print) -> dict:
    """Arms A-E on the mover scene of numpy seed SCENE_SEED."""
    dev = resolve_device(device)
    info, _, _ = build_scene_info(np.random.default_rng(SCENE_SEED), h=h, w=w,
                                  n_cams=n_cams)
    out = {"setting": {"hw": [h, w], "cams": n_cams, "iters": iters,
                       **_card(dev)}, "arms": {}}
    for a in ARMS:
        if a == "E":
            out["arms"]["E"] = arm_e(info, iters=iters, n_frames=n_cams,
                                     pretrain_steps=pretrain_steps,
                                     device=dev, log=log)
        else:
            out["arms"][a] = train_arm(a, info, iters=iters, device=dev,
                                       log=log).record()
    return out


def run_seeds(seeds=SEEDS, *, h=H, w=W, n_cams=N_CAMS, iters=ITERS,
              device=None, log=print) -> dict:
    """Arm A at each Trainer seed of `seeds`; the sample standard deviation
    of their final held-out PSNR and the band it gives."""
    dev = resolve_device(device)
    info, _, _ = build_scene_info(np.random.default_rng(SCENE_SEED), h=h, w=w,
                                  n_cams=n_cams)
    runs = {str(s): train_arm("A", info, iters=iters, seed=s, device=dev,
                              log=log).record() for s in seeds}
    finals = [r["trend"][-1]["psnr"] for r in runs.values()]
    std = float(np.std(finals, ddof=1))
    return {"setting": {"hw": [h, w], "cams": n_cams, "iters": iters,
                        **_card(dev)},
            "runs": runs, "final_psnr": finals, "std": std,
            "band": psnr_band(std)}


def run_box(*, h=H, w=W, frames=BOX_FRAMES, iters=BOX_ITERS,
            every=BOX_EVERY, lambda_reg=BOX_LAMBDA_REG,
            baseline=BOX_BASELINE, device=None, log=print) -> dict:
    """Stereo box-pose recovery (quality_box_r05.py:44): the mover scene at
    `frames` frames x 2 eyes (one eye when `baseline` is 0, as
    quality_box.py ran it), numpy seed SCENE_SEED, the recipe of
    quality_full.py's Trainer (normal init, k_cap 2^14) without guidance
    or the perceptual term; every `every` iterations the mean translation
    error and the held-out PSNR with the boxes."""
    dev = resolve_device(device)
    info, true_b2w, _ = build_scene_info(
        np.random.default_rng(SCENE_SEED), h=h, w=w, n_cams=frames,
        noise_t=BOX_NOISE, stereo_baseline=baseline)
    tr = build_trainer(info, box_config(lambda_reg), k_cap=BOX_K_CAP,
                       norminit=True, device=dev)
    run = Run("box", tr, log=log)
    err0, raw = box_pose_errors(tr, true_b2w)
    errs = [(0, err0)]
    for it in range(1, iters + 1):
        run.step(it)
        if it % every == 0 or it == iters:
            errs.append((it, box_pose_errors(tr, true_b2w)[0]))
            run.evaluate(it, ssim=it == iters)
    final = errs[-1][1]
    return {"setting": {"hw": [h, w], "frames": frames,
                        "eyes": 2 if baseline else 1, "baseline": baseline,
                        "noise_t": BOX_NOISE,
                        "lambda_reg": lambda_reg, "iters": iters,
                        **_card(dev)},
            **run.record(), "err_raw": raw, "err_trend": errs,
            "err_final": final, "recovered": 1.0 - final / raw}


def run_static(*, hw=STATIC_HW, n_cams=N_CAMS, iters=STATIC_ITERS,
               every=STATIC_EVERY, device=None, log=print) -> dict:
    """The round-2 static recipe (quality_r02.py:49): the scene without the
    mover or normal maps from numpy seed 0, held-out PSNR every `every`."""
    from ..scene import dataset_readers as dr
    from ..utils import synthetic as syn

    dev = resolve_device(device)
    h, w = hw
    rng = np.random.default_rng(0)
    infos = syn.street_camera_infos(n_cams, h, w, render_gt=True)
    pts, cols = syn.sample_scene_points(rng, n_ground=3000, n_box=600)
    pcd = dr.BasicPointCloud(pts, cols)
    info = dr.SceneInfo(
        point_cloud=pcd,
        train_cameras=[c for i, c in enumerate(infos) if i % 8 != 0],
        test_cameras=[c for i, c in enumerate(infos) if i % 8 == 0],
        nerf_normalization=dr.getNerfppNorm(infos, pcd), ply_path="")
    tr = build_trainer(info, static_config(), k_cap=STATIC_K_CAP, device=dev)
    run = Run("static", tr, log=log)
    run.evaluate(0, boxes=False, ssim=False)
    run.train(1, iters, every, boxes=False, ssim=False)
    return {"setting": {"hw": list(hw), "cams": n_cams, "iters": iters,
                        **_card(dev)}, **run.record()}


# -- the superseded runs: quality_full.py (r03), quality_full_r04.py (r04),
# quality_box.py (box_r04) ----------------------------------------------------

# -- r03: quality_full.py's settings ------------------------------------------
R03_HW, R03_CAMS, R03_ITERS, R03_EVERY = (64, 128), 17, 1000, 100
R03_K_CAP = 1 << 14
R03_GUIDE_FRAC = 0.75        # the window [0.75 x ITERS, ITERS]

# -- r04: quality_full_r04.py's (at the recorded run's 1,400 iterations) ------
R04_HW, R04_CAMS, R04_ITERS, R04_EVERY = (128, 256), 17, 1400, 200
R04_K_CAP = 1 << 15
R04_PRETRAIN = 1500
R04_SM_LAMBDA = 3e-7
R04_TRUNK_FRAC = 0.6         # the trunk, and densify, to 0.6 x ITERS

# -- box_r04: quality_box.py's ------------------------------------------------
BOXR04_HW, BOXR04_CAMS, BOXR04_ITERS, BOXR04_EVERY = (128, 256), 9, 1200, 100
BOXR04_SWEEP = (1e-3, 1e-4)

# -- the JAX package's recorded readings --------------------------------------
# QUALITY_FULL_r03.md: iteration -> (PSNR, SSIM, active Gaussians, box err)
JAX_R03 = {0: (5.41, 0.064, 11424, 0.125),
           100: (6.13, 0.332, 11424, 0.123),
           200: (6.52, 0.381, 13429, 0.123),
           300: (7.17, 0.441, 15838, 0.123),
           400: (8.00, 0.487, 19129, 0.123),
           500: (9.09, 0.534, 22657, 0.123),
           600: (10.11, 0.562, 27074, 0.123),
           700: (10.85, 0.618, 32818, 0.123),
           800: (11.59, 0.661, 32818, 0.123),
           900: (11.80, 0.686, 32818, 0.123),
           1000: (11.92, 0.710, 32818, 0.123)}
JAX_R03_RAW_ERR, JAX_R03_GUIDED = 0.125, 249
# The port's own final held-out PSNR of r03, its first reading on the card
# (`--run r03` on an H100 80GB HBM3 at 700 W, QUALITY_TORCH.md); chip_smoke
# read 28.21 dB in the same run-up.
PORT_R03_FINAL = 28.2004
# QUALITY_FULL_r04.md: trunk iteration -> (test PSNR, SSIM, aug PSNR,
# SSIM, active); branch iteration -> ((guided test, aug), (unguided ...))
JAX_R04_TRUNK = {0: (5.25, 0.090, 5.04, 0.081, 11424),
                 200: (5.90, 0.434, 5.77, 0.352, 13254),
                 400: (6.17, 0.491, 6.06, 0.428, 15538),
                 600: (6.58, 0.511, 6.47, 0.509, 21076),
                 800: (7.05, 0.570, 6.88, 0.508, 24758),
                 840: (7.04, 0.572, 6.90, 0.498, 24758)}
JAX_R04_BRANCH = {
    1000: ((6.98, 0.572, 6.87, 0.504), (6.99, 0.573, 6.86, 0.501)),
    1200: ((6.97, 0.571, 6.87, 0.501), (6.95, 0.571, 6.84, 0.499)),
    1400: ((6.94, 0.577, 6.86, 0.479), (6.94, 0.574, 6.82, 0.494))}
JAX_R04_PRETRAIN, JAX_R04_GUIDED = (1.403, 0.210), 559
# QUALITY_BOX_r04.md: lambda_reg -> (raw err, final err, recovered)
JAX_BOX_R04 = {1e-3: (0.1548, 0.1088, 0.30), 1e-4: (0.1548, 0.1981, -0.28)}
JAX_BOX_R04_TREND = {
    1e-3: (0.1548, 0.1654, 0.1603, 0.1606, 0.1450, 0.1328, 0.1226, 0.1179,
           0.1141, 0.1134, 0.1093, 0.1110, 0.1088),
    1e-4: (0.1548, 0.1876, 0.2092, 0.2278, 0.2049, 0.1890, 0.1855, 0.1917,
           0.1974, 0.1925, 0.1902, 0.1958, 0.1981)}

PREDATES = {
    "r03": "the box-delta safe_norm fix (34c0164; quality_box.py:6-8: the "
           "deltas never left identity, hence the frozen 0.123 m column) "
           "and the SSIM gradient fix (b15ede2)",
    "r04": "the SSIM gradient fix (b15ede2: float32 SSIM filters and "
           "clamped variances; without it the DSSIM gradient at 128x256 was "
           "~100x corrupted and the JAX run plateaued near 7 dB)",
    "box_r04": "the SSIM gradient fix (b15ede2); it postdates the safe_norm "
               "fix, which let its deltas move at all",
}


def r03_config():
    """quality_full.py:103-123's overrides: the static recipe (densify
    [100, 700] every 100 at tau 0.0004), the VGG perceptual term at 0.01,
    the guidance window [750, 1000] at sm_lambda 1e-7, 32-pixel SD
    crops. `box_config` is the same without the perceptual term."""
    cfg = box_config()
    cfg.sd.perceptual_loss = True
    return cfg


def r04_config(iters: int = R04_ITERS):
    """quality_full_r04.py:160-177's overrides: densify [100, 0.6 x iters]
    every 150 at tau 0.0004, the perceptual term at 0.01, the guidance
    window closed (the guided branch opens it)."""
    from ..config import VegsConfig

    cfg = VegsConfig()
    cfg.opt.densify_from_iter = 100
    cfg.opt.densification_interval = 150
    cfg.opt.densify_until_iter = int(iters * R04_TRUNK_FRAC)
    cfg.opt.opacity_reset_interval = 10_000
    cfg.opt.densify_grad_threshold = 0.0004
    cfg.sd.perceptual_loss = True
    cfg.sd.perceptual_loss_lambda = 0.01
    cfg.sd.sd_image_size = SD_IMAGE_SIZE
    cfg.sd.start_guiding_from_iter = 10 ** 9
    cfg.sd.end_guiding_at_iter = 10 ** 9
    return cfg


def tiny_sd(dev, seed: int = 0):
    """The tiny SD stack at 32-pixel crops, random weights from a
    generator seeded `seed` on `dev` (quality_full.py:135)."""
    from ..diffusion.pipeline import DiffusionModels

    g = torch.Generator(device=dev).manual_seed(seed)
    return DiffusionModels.tiny(g, image_size=SD_IMAGE_SIZE)


def r03_trainer(info, iters: int = R03_ITERS, device=None):
    """quality_full.py:98's Trainer: `r03_config`, k_cap 2^14, Trainer
    seed 3, the normal-prior init, score-matching guidance by the tiny SD
    stack with random weights (max_step 50) in [0.75 x iters, iters]."""
    from ..losses.sd_guidance import SDGuidance

    dev = resolve_device(device)
    cfg = r03_config()
    guide_from = int(iters * R03_GUIDE_FRAC)
    cfg.sd.start_guiding_from_iter, cfg.sd.end_guiding_at_iter = (guide_from,
                                                                  iters)
    tr = build_trainer(info, cfg, k_cap=R03_K_CAP, norminit=True,
                         device=dev)
    tr.sd_guidance = SDGuidance(tiny_sd(dev), guidance_mode="score-matching",
                                start_iter=guide_from, max_iters=iters,
                                max_step=50)
    return tr


def run_r03(*, hw=R03_HW, n_cams=R03_CAMS, iters=R03_ITERS, every=R03_EVERY,
            device=None, log=print) -> dict:
    """quality_full.py:179-216: `r03_trainer` on the mover scene of numpy
    seed 7, evaluated (held-out PSNR, SSIM, active Gaussians with the box
    composited; the box's mean translation error) at 0, every `every` and
    at the end."""
    dev = resolve_device(device)
    h, w = hw
    info, true_b2w, _ = build_scene_info(
        np.random.default_rng(SCENE_SEED), h=h, w=w, n_cams=n_cams)
    tr = r03_trainer(info, iters, dev)
    run = Run("r03", tr, log=log)
    err0, raw = box_pose_errors(tr, true_b2w)
    run.evaluate(0)
    errs = [(0, err0)]
    for it in range(1, iters + 1):
        run.step(it)
        if it % every == 0 or it == iters:
            run.evaluate(it)
            errs.append((it, box_pose_errors(tr, true_b2w)[0]))
    return {"setting": {"hw": [h, w], "cams": n_cams, "iters": iters,
                        "guide": [int(iters * R03_GUIDE_FRAC), iters],
                        **_card(dev)},
            **run.record(), "err_raw": raw, "err_trend": errs}


def run_r04(*, hw=R04_HW, n_cams=R04_CAMS, iters=R04_ITERS, every=R04_EVERY,
            pretrain_steps=R04_PRETRAIN, device=None, log=print) -> dict:
    """quality_full_r04.py:207-301: the tiny UNet pretrained on the
    training images (the VAE's random weights kept), the trunk to 0.6 x
    `iters` unguided, a snapshot, the guided branch (sm_lambda 3e-7, the
    window [0.6 x iters, iters]) and the unguided branch from it, each
    evaluated on the held-out and the yawed views every `every`, at the
    fork and at the end."""
    from ..losses.sd_guidance import SDGuidance

    dev = resolve_device(device)
    h, w = hw
    guide_from = int(iters * R04_TRUNK_FRAC)
    info, _, _ = build_scene_info(np.random.default_rng(SCENE_SEED),
                                    h=h, w=w, n_cams=n_cams)
    train_imgs = np.stack([np.asarray(c.image) for c in info.train_cameras])
    t0 = time.perf_counter()
    models, unet_losses = pretrain_unet(tiny_sd(dev), train_imgs,
                                          steps=pretrain_steps)
    _sync(dev)
    pre_s = time.perf_counter() - t0
    log(f"[r04] pretrain: unet {unet_losses[0]:.4f} -> {unet_losses[-1]:.4f}"
        f" ({pre_s:.1f} s)")
    tr = build_trainer(info, r04_config(iters), k_cap=R04_K_CAP,
                         norminit=True, device=dev)
    aug = make_aug_cameras(tr.scene.getTestCameras(), n_cams)
    trunk = Run("r04-trunk", tr, aug_cams=aug, log=log)
    trunk.evaluate(0)
    trunk.train(1, guide_from, every)
    snap = snapshot_trainer(tr)

    tr.sd_guidance = SDGuidance(models, guidance_mode="score-matching",
                                start_iter=guide_from, max_iters=iters,
                                max_step=50, sm_lambda=R04_SM_LAMBDA)
    tr.cfg.sd.start_guiding_from_iter = guide_from
    tr.cfg.sd.end_guiding_at_iter = iters
    tr.cfg.sd.sm_lambda = R04_SM_LAMBDA
    guided = Run("r04-guided", tr, aug_cams=aug, log=log)
    guided.train(guide_from + 1, iters, every)

    restore_trainer(tr, snap)
    tr.sd_guidance = None
    tr.cfg.sd.start_guiding_from_iter = 10 ** 9
    tr.cfg.sd.end_guiding_at_iter = 10 ** 9
    unguided = Run("r04-unguided", tr, aug_cams=aug, log=log)
    unguided.train(guide_from + 1, iters, every)
    return {"setting": {"hw": [h, w], "cams": n_cams, "iters": iters,
                        "trunk_to": guide_from, **_card(dev)},
            "trunk": trunk.record(), "guided": guided.record(),
            "unguided": unguided.record(),
            "pretrain": {"unet": unet_losses, "steps": pretrain_steps,
                         "seconds": pre_s}}


def run_box_r04(*, hw=BOXR04_HW, n_cams=BOXR04_CAMS, iters=BOXR04_ITERS,
                every=BOXR04_EVERY, sweep=BOXR04_SWEEP, device=None,
                log=print) -> dict:
    """quality_box.py:40-100: `run_box` with one eye at each
    lambda_reg of `sweep`."""
    h, w = hw
    return {"setting": {"hw": [h, w], "cams": n_cams, "iters": iters,
                        "noise_t": BOX_NOISE, **_card(resolve_device(
                            device))},
            "runs": {f"{lam:g}": run_box(h=h, w=w, frames=n_cams,
                                           iters=iters, every=every,
                                           lambda_reg=lam, baseline=0.0,
                                           device=device, log=log)
                     for lam in sweep}}


# -- holding and reporting ----------------------------------------------------


def held_legacy(records: dict, band: float) -> list:
    """`held`'s rows for r03: the final held-out PSNR at or above JAX's
    less `band` and within `band` of the port's own card reading, and the
    untrained reading at iteration 0 missing both (the control)."""
    r03 = records.get("r03")
    if not r03:
        return []
    jax_final = JAX_R03[R03_ITERS][0]
    last, first = r03["trend"][-1], r03["trend"][0]

    def holds(psnr):
        return (psnr >= jax_final - band, within(psnr, PORT_R03_FINAL, band))

    return [(f"r03 it{last['it']} PSNR, one-sided: at or above JAX's less "
             "the band", last["psnr"], jax_final, band,
             holds(last["psnr"])[0]),
            (f"r03 it{last['it']} PSNR against the port's own card reading",
             last["psnr"], PORT_R03_FINAL, band, holds(last["psnr"])[1]),
            (f"r03 it{first['it']} PSNR (untrained control), must miss both",
             first["psnr"], jax_final, band, not any(holds(first["psnr"])))]


def _pair(p, s):
    return f"{p:.2f}/{s:.3f}"


def render_legacy(records: dict) -> list:
    """The report's sections of the r03, r04 and box_r04 runs, each beside
    the JAX readings and the fixes those predate."""
    L = []
    r03 = records.get("r03")
    if r03:
        s = r03["setting"]
        L += ["## r03: the full model (QUALITY_FULL_r03, superseded)",
              "", f"{s['hw'][0]}x{s['hw'][1]}, {s['cams']} cameras, "
              f"{s['iters']} iterations, the mover with 0.08 m noise, normal "
              f"init, perceptual 0.01, tiny SD (random weights) guiding in "
              f"{s['guide']}; {_card_of(r03)}. The JAX reading predates "
              f"{PREDATES['r03']}.", "",
              "| iteration | port PSNR / SSIM | JAX PSNR / SSIM | port "
              "Gaussians | JAX Gaussians | port box err (m) | JAX box err "
              "(m) |",
              "|---|---|---|---|---|---|---|"]
        errs = dict(r03["err_trend"])
        for r in r03["trend"]:
            j = JAX_R03.get(r["it"])
            jq, jn, je = ((_pair(j[0], j[1]), j[2], f"{j[3]:.3f}") if j
                          else ("", "", ""))
            L += [f"| {r['it']} | {_pair(r['psnr'], r['ssim'])} | {jq} | "
                  f"{r['n']} | {jn} | {errs.get(r['it'], float('nan')):.3f} "
                  f"| {je} |"]
        L += ["", f"Raw annotation error: port {r03['err_raw']:.3f} m, JAX "
              f"{JAX_R03_RAW_ERR} m. Guided iterations: port "
              f"{r03['guided_iters']}, JAX {JAX_R03_GUIDED}.", "",
              f"Timing: {_timing(r03)}", ""]
    r04 = records.get("r04")
    if r04:
        s = r04["setting"]
        pre = r04["pretrain"]
        L += ["## r04: the guidance ablation (QUALITY_FULL_r04, superseded)",
              "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['cams']} cameras, {s['iters']} "
              f"iterations, the trunk to {s['trunk_to']}, then guided (sm "
              f"3e-7) and unguided branches from one snapshot; "
              f"{_card_of(r04)}. The tiny UNet pretrained {pre['steps']} "
              f"steps: eps-MSE {pre['unet'][0]:.3f} -> {pre['unet'][-1]:.3f} "
              f"(JAX {JAX_R04_PRETRAIN[0]} -> {JAX_R04_PRETRAIN[1]}), "
              f"{pre['seconds']:.1f} s. The JAX reading predates "
              f"{PREDATES['r04']}.", "",
              "Trunk (test PSNR/SSIM, extrapolated PSNR/SSIM, active):", "",
              "| iteration | port test | JAX test | port aug | JAX aug | port "
              "active | JAX active |", "|---|---|---|---|---|---|---|"]
        for r in r04["trunk"]["trend"]:
            j = JAX_R04_TRUNK.get(r["it"])
            L += [f"| {r['it']} | {_pair(r['psnr'], r['ssim'])} | "
                  f"{_pair(j[0], j[1]) if j else ''} | "
                  f"{_pair(r['aug_psnr'], r['aug_ssim'])} | "
                  f"{_pair(j[2], j[3]) if j else ''} | {r['n']} | "
                  f"{j[4] if j else ''} |"]
        L += ["", "Branches (test / extrapolated PSNR/SSIM):", "",
              "| iteration | port guided | JAX guided | port unguided | JAX "
              "unguided |", "|---|---|---|---|---|"]
        for g, u in zip(r04["guided"]["trend"], r04["unguided"]["trend"]):
            j = JAX_R04_BRANCH.get(g["it"])

            def cell(r):
                return (f"{_pair(r['psnr'], r['ssim'])} / "
                        f"{_pair(r['aug_psnr'], r['aug_ssim'])}")

            def jcell(x):
                return f"{_pair(x[0], x[1])} / {_pair(x[2], x[3])}"
            L += [f"| {g['it']} | {cell(g)} | {jcell(j[0]) if j else ''} | "
                  f"{cell(u)} | {jcell(j[1]) if j else ''} |"]
        g, u = r04["guided"]["trend"][-1], r04["unguided"]["trend"][-1]
        L += ["", f"Guidance effect (guided - unguided) at it{g['it']}: "
              f"extrapolated {g['aug_psnr'] - u['aug_psnr']:+.2f} dB, "
              f"held-out "
              f"{g['psnr'] - u['psnr']:+.2f} dB (JAX +0.04 / +0.01). Guided "
              f"iterations: port {r04['guided']['guided_iters']}, JAX "
              f"{JAX_R04_GUIDED}.", ""]
        for part in ("trunk", "guided", "unguided"):
            L += [f"- {part}: {_timing(r04[part])}"]
        L += [""]
    box = records.get("box_r04")
    if box:
        s = box["setting"]
        L += ["## box_r04: pose recovery (QUALITY_BOX_r04, superseded)", "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['cams']} cameras (one eye), "
              f"{s['noise_t']} m injected noise, {s['iters']} iterations, no "
              f"guidance or perceptual term; {_card_of(box)}. The JAX "
              f"reading predates {PREDATES['box_r04']}.", "",
              "| lambda_reg | port raw / final err (m) | port recovered | JAX "
              "raw / final err (m) | JAX recovered | port test PSNR |",
              "|---|---|---|---|---|---|"]
        for lam, r in box["runs"].items():
            j = JAX_BOX_R04.get(float(lam))
            L += [f"| {lam} | {r['err_raw']:.4f} / {r['err_final']:.4f} | "
                  f"{100 * r['recovered']:.0f}% | "
                  f"{f'{j[0]} / {j[1]}' if j else ''} | "
                  f"{f'{100 * j[2]:.0f}%' if j else ''} | "
                  f"{r['trend'][-1]['psnr']:.2f} |"]
        L += ["", "Error trend (m), port then JAX:", ""]
        for lam, r in box["runs"].items():
            jt = JAX_BOX_R04_TREND.get(float(lam), ())
            L += [f"- lambda_reg {lam}: " + ", ".join(
                f"it{i}={e:.4f}" for i, e in r["err_trend"]),
                "  JAX: " + ", ".join(
                    f"it{100 * i}={e:.4f}" for i, e in enumerate(jt)),
                f"  {_timing(r)}"]
        L += [""]
    return L


# -- holding the readings ----------------------------------------------------------------


def within(value: float, ref: float, band: float) -> bool:
    return bool(abs(value - ref) <= band)


def held(records: dict) -> list:
    """(what, port reading, reference, limit, within) of every held
    reading in `records` (the report's runs); the reference is the JAX
    reading, or the held target where noted."""
    band = PSNR_BAND_DB
    rows = []
    arms = records.get("full", {}).get("arms", {})
    for a, (jp, js) in JAX_FULL.items():
        if a not in arms:
            continue
        last = (arms[a]["unguided"] if a == "E" else arms[a])["trend"][-1]
        rows.append((f"arm {a} PSNR", last["psnr"], jp, band,
                     within(last["psnr"], jp, band)))
        rows.append((f"arm {a} SSIM", last["ssim"], js, SSIM_BAND,
                     within(last["ssim"], js, SSIM_BAND)))
    if "E" in arms:
        g = arms["E"]["guided"]["guided_iters"]
        rows.append(("E guided iterations (target 375; JAX counted "
                     f"{JAX_BRANCH['guided_iters']})", g, GUIDED_ITERS,
                     GUIDED_ITERS_BAND,
                     within(g, GUIDED_ITERS, GUIDED_ITERS_BAND)))
    box = records.get("box")
    if box:
        p = box["trend"][-1]["psnr"]
        rows.append(("box run test PSNR", p, JAX_BOX["psnr"], band,
                     within(p, JAX_BOX["psnr"], band)))
        rows.append(("box final error (m) against its raw error: must "
                     "differ", box["err_final"], box["err_raw"], 0.0,
                     box["err_final"] != box["err_raw"]))
    smoke = records.get("smoke")
    if smoke:
        a = smoke["arm_a"]["trend"][-1]
        rows.append(("chip_smoke arm A PSNR", a["psnr"], JAX_FULL["A"][0],
                     band, within(a["psnr"], JAX_FULL["A"][0], band)))
        rows.append(("chip_smoke arm A SSIM", a["ssim"], JAX_FULL["A"][1],
                     SSIM_BAND, within(a["ssim"], JAX_FULL["A"][1],
                                       SSIM_BAND)))
        c = smoke["control"]["trend"][-1]
        rows.append((f"control (the JAX round-5 SSIM) it{c['it']} PSNR, "
                     "must miss", c["psnr"], JAX_A_IT900, band,
                     not within(c["psnr"], JAX_A_IT900, band)))
    return rows + held_legacy(records, band)


# -- the report -----------------------------------------------------------------------------

_DATA = re.compile(r"<!-- quality-records\n(.*)\n-->", re.S)


def read_records(path) -> dict:
    """The runs' records kept in a report (empty without one)."""
    p = Path(path)
    if not p.exists():
        return {}
    m = _DATA.search(p.read_text())
    return json.loads(m.group(1)) if m else {}


def _trend(rows, key="psnr") -> str:
    return ", ".join(f"it{r['it']}={r[key]:.2f}" for r in rows)


def _card_of(rec) -> str:
    s = rec.get("setting", rec)
    return s.get("card") or s.get("device", "?")


def _timing(rec) -> str:
    ms = rec.get("ms_per_step_median")
    ms = "not measured" if ms is None else f"{ms:.2f}"
    launches = ", ".join(f"{k} {v}" for k, v in rec["launches"].items())
    path = ", ".join(f"it{i} {k}/{p}" for i, k, p in rec["kcap_path"])
    return (f"{rec.get('steps', 0)} steps, median {ms} ms a step, "
            f"{rec['wall_s']:.1f} s wall; launches {launches}; k_cap/k_pad "
            f"{path}")


def render_report(records: dict) -> str:
    """QUALITY_TORCH.md from the runs' records."""
    L = ["# QUALITY_TORCH — the port's end-to-end quality on the card",
         "",
         "Written by `python -m vegs_torch.perf.quality --run "
         "static|full|box|seeds|r03|r04|box_r04` (and chip_smoke.py's",
         "quality phase with `--quality-out`): the JAX package's quality",
         "harness ported to `vegs_torch.perf.quality`,",
         "trained on the card through K1-K4 on the ray-traced street oracle,",
         "each reading beside the JAX package's recorded one",
         "(QUALITY_FULL_r05.md, QUALITY_BOX_r05.md, QUALITY_r02.md, and the",
         "superseded QUALITY_FULL_r03.md, QUALITY_FULL_r04.md,",
         "QUALITY_BOX_r04.md). Times are the card's named beside them; the",
         "JAX readings are quality numbers only.", ""]
    seeds = records.get("seeds")
    L += ["## The band", ""]
    if seeds:
        s = seeds["setting"]
        L += [f"Arm A (static-only, {s['hw'][0]}x{s['hw'][1]}, {s['cams']} "
              f"cameras, {s['iters']} iterations) at Trainer seeds "
              f"{', '.join(seeds['runs'])}: final held-out PSNR "
              + ", ".join(f"{p:.2f}" for p in seeds["final_psnr"])
              + f" dB, sample standard deviation {seeds['std']:.3f} dB. "
              f"Band = max(1 dB, 3 x std) = **{seeds['band']:.2f} dB** "
              f"({_card_of(seeds)}).", ""]
        for s, r in seeds["runs"].items():
            L += [f"- seed {s}: {_trend(r['trend'])}; {_timing(r)}"]
        L += [""]
    else:
        L += ["Not measured yet (`--run seeds`).", ""]
    L += [f"Fixed in `vegs_torch/perf/quality.py` before the arms were read: "
          f"PSNR_BAND_DB = {PSNR_BAND_DB:.3f} (std {SEED_PSNR_STD:.4f}). "
          f"SSIM is held within {SSIM_BAND}.", ""]

    rows = held(records)
    if rows:
        L += ["## Held readings", "",
              "| reading | port | reference (JAX) | limit | within |",
              "|---|---|---|---|---|"]
        for what, got, ref, lim, ok in rows:
            L += [f"| {what} | {got:.4f} | {ref:.4f} | {lim:g} | "
                  f"{'yes' if ok else 'NO'} |"]
        L += [""]

    full = records.get("full")
    if full:
        s = full["setting"]
        L += ["## Arms A-E (QUALITY_FULL_r05's recipe)", "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['cams']} cameras (idx % 8 "
              f"split), {s['iters']} iterations, densify [100, "
              f"{int(s['iters'] * 0.6)}] every 100 at tau 0.0002, k_cap "
              f"2^17 with the adapter free; {_card_of(full)}.", "",
              "| arm | config | port PSNR | JAX PSNR | port SSIM | JAX SSIM "
              "| port Gaussians |", "|---|---|---|---|---|---|---|"]
        for a, rec in full["arms"].items():
            last = (rec["unguided"] if a == "E" else rec)["trend"][-1]
            jp, js = JAX_FULL[a]
            L += [f"| {a} | {ARM_NAMES[a]} | {last['psnr']:.2f} | {jp:.2f} "
                  f"| {last['ssim']:.3f} | {js:.3f} | {last['n']} |"]
        L += ["", "Trends (held-out PSNR, dB), port then JAX:", ""]
        for a, rec in full["arms"].items():
            tr = (rec["trunk"]["trend"] + rec["unguided"]["trend"]
                  if a == "E" else rec["trend"])
            L += [f"- **{a}** port: {_trend(tr)}", f"  JAX: {JAX_FULL_TREND[a]}"]
            for part in (("trunk", "guided", "unguided") if a == "E"
                         else (None,)):
                r = rec[part] if part else rec
                L += [f"  {part or 'run'}: {_timing(r)}"]
        e = full["arms"].get("E")
        if e:
            g, u = e["guided"]["trend"][-1], e["unguided"]["trend"][-1]
            pre = e["pretrain"]
            L += ["", "### Arm E's guidance branches", "",
                  f"Tiny SD pretrained {pre['steps']} steps on the scene: UNet "
                  f"eps-MSE {pre['unet'][0]:.3f} -> {pre['unet'][-1]:.3f} (JAX "
                  f"{JAX_PRETRAIN['unet'][0]} -> {JAX_PRETRAIN['unet'][1]}), "
                  f"VAE loss {pre['vae'][0]:.4f} -> {pre['vae'][1]:.4f} (JAX "
                  f"{JAX_PRETRAIN['vae'][0]} -> {JAX_PRETRAIN['vae'][1]}), "
                  f"{pre['seconds']:.1f} s.", "",
                  "| branch | port test | JAX test | port extrapolated | "
                  "JAX extrapolated |", "|---|---|---|---|---|",
                  f"| guided | {g['psnr']:.2f} | {JAX_BRANCH['guided'][0]:.2f} "
                  f"| {g['aug_psnr']:.2f} | {JAX_BRANCH['guided'][1]:.2f} |",
                  f"| unguided | {u['psnr']:.2f} | "
                  f"{JAX_BRANCH['unguided'][0]:.2f} | {u['aug_psnr']:.2f} | "
                  f"{JAX_BRANCH['unguided'][1]:.2f} |", "",
                  f"Guidance effect (guided - unguided): extrapolated "
                  f"{g['aug_psnr'] - u['aug_psnr']:+.2f} dB, held-out "
                  f"{g['psnr'] - u['psnr']:+.2f} dB (JAX +0.03 / +0.24, inside "
                  f"its noise; not held). Guided iterations: "
                  f"{e['guided']['guided_iters']} (JAX counted "
                  f"{JAX_BRANCH['guided_iters']}).", ""]
    box = records.get("box")
    if box:
        s = box["setting"]
        L += ["## Stereo box-pose recovery (QUALITY_BOX_r05's setting)", "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['frames']} frames x 2 eyes "
              f"({s['baseline']} m baseline), {s['noise_t']} m injected "
              f"translation noise, lambda_reg {s['lambda_reg']:g}, "
              f"{s['iters']} iterations; {_card_of(box)}.", "",
              "| | port | JAX |", "|---|---|---|",
              f"| test PSNR (dB) | {box['trend'][-1]['psnr']:.2f} | "
              f"{JAX_BOX['psnr']} |",
              f"| raw error (m) | {box['err_raw']:.4f} | {JAX_BOX['err_raw']} |",
              f"| final error (m) | {box['err_final']:.4f} | "
              f"{JAX_BOX['err_final']} |",
              f"| recovered | {100 * box['recovered']:.0f}% | "
              f"{100 * JAX_BOX['recovered']:.0f}% |", "",
              "Error trend (m): " + ", ".join(f"it{i}={e:.4f}"
                                               for i, e in box["err_trend"]),
              "", f"PSNR trend: {_trend(box['trend'])}", "",
              f"Timing: {_timing(box)}", ""]
    static = records.get("static")
    if static:
        s = static["setting"]
        L += ["## The round-2 static recipe (beside QUALITY_r02, not held)", "",
              f"{s['hw'][0]}x{s['hw'][1]}, {s['cams']} cameras, {s['iters']} "
              f"iterations; {_card_of(static)}.", "",
              "| iteration | port PSNR | JAX PSNR (r02) | port Gaussians |",
              "|---|---|---|---|"]
        for r in static["trend"]:
            L += [f"| {r['it']} | {r['psnr']:.2f} | "
                  f"{JAX_STATIC.get(r['it'], float('nan')):.2f} | {r['n']} |"]
        L += ["", f"Timing: {_timing(static)}", ""]
    smoke = records.get("smoke")
    if smoke:
        L += ["## chip_smoke.py's quality phase", "",
              f"Arm A in full ({_card_of(smoke)}): "
              f"{_trend(smoke['arm_a']['trend'])}; {_timing(smoke['arm_a'])}.",
              "", "Controls, read against the band around JAX's it900 "
              f"reading {JAX_A_IT900} dB:", "",
              "- SSIM's filter in bf16 (input and window cast), the "
              "variance clamp kept (reported): "
              f"{_trend(smoke['control_bf16']['trend'])}; "
              f"{_timing(smoke['control_bf16'])}.",
              "- the JAX package's SSIM before its round-5 fix (the filter "
              "in bf16, the variances unclamped; must miss): "
              f"{_trend(smoke['control']['trend'])}; "
              f"{_timing(smoke['control'])}.", "",
              "Evaluation SSIM under a control is computed with the patched "
              "SSIM; its PSNR is not.", "",
              f"Phase {smoke['phase_s']:.1f} s.", ""]
    L += render_legacy(records)
    L += ["<!-- quality-records", json.dumps(records), "-->", ""]
    return "\n".join(L)


def write_report(path, run: str, record: dict) -> dict:
    """Put `record` under `run` among the report's records and rewrite it.
    Returns all records."""
    records = read_records(path)
    records[run] = record
    Path(path).write_text(render_report(records))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True,
                    choices=("static", "full", "box", "seeds", "r03", "r04",
                             "box_r04"))
    ap.add_argument("--out", default=str(REPORT))
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, flush=True)

    rec = {"static": run_static, "full": run_full, "box": run_box,
           "seeds": run_seeds, "r03": run_r03, "r04": run_r04,
           "box_r04": run_box_r04}[args.run](device=dev, log=log)
    records = write_report(args.out, args.run, rec)
    rows = held(records)
    for r in rows:
        log(json.dumps({"held": r[0], "port": r[1], "jax": r[2],
                        "limit": r[3], "within": r[4]}))
    log(f"wrote {args.out}")
    return 1 if any(ok is False for *_, ok in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
