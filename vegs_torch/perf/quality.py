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

Run on the card:  python -m vegs_torch.perf.quality --run static|full|box|seeds
                  [--out PATH]
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
    from ..ops import blend_cuda, satcull, segreduce

    return {"K1": blend_cuda.blend.launches,
            "K2": blend_cuda.blend_bwd.launches,
            "K3": segreduce.gather_expand_bwd.launches,
            "K4": satcull.satcount_gathered.launches}


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
            row["aug_psnr"] = tr.evaluate(cameras=self.aug_cams,
                                          with_boxes=boxes,
                                          with_ssim=ssim)["psnr"]
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
            every=BOX_EVERY, lambda_reg=BOX_LAMBDA_REG, device=None,
            log=print) -> dict:
    """Stereo box-pose recovery (quality_box_r05.py:44): the mover scene at
    `frames` frames x 2 eyes, numpy seed SCENE_SEED, the recipe of
    quality_full.py's Trainer (normal init, k_cap 2^14) without guidance
    or the perceptual term; every `every` iterations the mean translation
    error and the held-out PSNR with the boxes."""
    dev = resolve_device(device)
    info, true_b2w, _ = build_scene_info(
        np.random.default_rng(SCENE_SEED), h=h, w=w, n_cams=frames,
        noise_t=BOX_NOISE, stereo_baseline=BOX_BASELINE)
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
    return {"setting": {"hw": [h, w], "frames": frames, "eyes": 2,
                        "baseline": BOX_BASELINE, "noise_t": BOX_NOISE,
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
    return rows


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
         "static|full|box|seeds` (and chip_smoke.py's quality phase with",
         "`--quality-out`): the JAX package's quality harness ported to",
         "`vegs_torch.perf.quality`, trained on the card through K1-K4 on the",
         "ray-traced street oracle, each reading beside the JAX package's",
         "recorded one (QUALITY_FULL_r05.md, QUALITY_BOX_r05.md,",
         "QUALITY_r02.md). Times are the card's named beside them; the JAX",
         "readings are quality numbers only.", ""]
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
                    choices=("static", "full", "box", "seeds"))
    ap.add_argument("--out", default=str(REPORT))
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, flush=True)

    rec = {"static": run_static, "full": run_full, "box": run_box,
           "seeds": run_seeds}[args.run](device=dev, log=log)
    records = write_report(args.out, args.run, rec)
    rows = held(records)
    for r in rows:
        log(json.dumps({"held": r[0], "port": r[1], "jax": r[2],
                        "limit": r[3], "within": r[4]}))
    log(f"wrote {args.out}")
    return 1 if any(ok is False for *_, ok in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
