"""Training loop, static scenes (port of the static path of
vegs_tpu/train.py).

One step: render the field through the rasterizer with a zero means2d tap
(`render._run`), score (1 - lambda) L1 + lambda (1 - SSIM) plus the
normal-guidance term, backpropagate with PyTorch autograd (kernels K2 and K3
inside the blend's and the gather's backward), take the Adam step
(`optim.adam_step`, in place) and fold the tap's gradient into the densify
statistics. Between steps the host adapts the tile-instance capacities and
densifies, prunes and resets opacity on the reference's schedule.

Not ported yet: dynamic boxes and the pooled step, diffusion guidance and
the perceptual term, data parallelism, checkpoints, the CLI (`main`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import densify, optim, resolve_device
from .config import VegsConfig
from .gaussians import DensifyStats, GaussianField
from .losses import l1_loss, loss_normal_guidance, psnr, ssim
from .ops.projection import CameraParams
from .ops.rasterize import RasterizeConfig, RasterOut
from .render import field_arrays, _run
from .scene import Scene


@dataclasses.dataclass
class TrainState:
    field: GaussianField
    opt: dict                # optim.adam_init layout: mu, nu, count
    stats: DensifyStats
    step: int


def image_loss(out: RasterOut, gt, normal, normal_valid, opt_cfg):
    """(loss, l1, normal_loss) of a rendered frame: (1 - lambda_dssim) L1 +
    lambda_dssim (1 - SSIM) + lambda_dnormal * normal_loss * normal_valid
    (normal_valid is 0 for a camera without a normal map)."""
    ll1 = l1_loss(out.rgb, gt)
    lam = opt_cfg.lambda_dssim
    nloss = loss_normal_guidance(out.cov_quat, out.cov_scale, normal)
    loss = ((1.0 - lam) * ll1 + lam * (1.0 - ssim(out.rgb, gt))
            + opt_cfg.lambda_dnormal * nloss * normal_valid)
    return loss, ll1, nloss


def loss_fn(field: GaussianField, m2d_offset, cam: CameraParams, gt, normal,
            normal_valid, active_sh_degree: int, bg, *, opt_cfg,
            raster_cfg: RasterizeConfig, sh_total_degree: int = 3):
    """The static step's loss (`image_loss`) of the field rendered with the
    means2d tap `m2d_offset` ([C, 2], zeros). Returns (loss, l1,
    normal_loss, RasterOut)."""
    out = _run(cam, field_arrays(field, active_sh_degree), bg=bg,
               scale_modifier=1.0, override_color=None,
               sh_degree=sh_total_degree, config=raster_cfg,
               means2d_offset=m2d_offset)
    return (*image_loss(out, gt, normal, normal_valid, opt_cfg), out)


def train_step(state: TrainState, cam: CameraParams, gt, normal, normal_valid,
               active_sh_degree: int, bg, *, opt_cfg, raster_cfg: RasterizeConfig,
               spatial_scale: float, sh_total_degree: int = 3):
    """One static step -> (state, metrics). The field's parameters, the Adam
    moments and the stats are updated in place; metrics are 0-d tensors on
    the field's device."""
    field = state.field
    for p in field.parameters():
        p.grad = None
    m2d_offset = torch.zeros((field.capacity, 2), dtype=torch.float32,
                             device=field.means.device, requires_grad=True)
    loss, ll1, nloss, out = loss_fn(
        field, m2d_offset, cam, gt, normal, normal_valid, active_sh_degree,
        bg, opt_cfg=opt_cfg, raster_cfg=raster_cfg,
        sh_total_degree=sh_total_degree)
    loss.backward()

    grads = {k: getattr(field, k).grad for k in optim.PARAM_LEAVES}
    grads = {k: torch.zeros_like(getattr(field, k)) if g is None else g
             for k, g in grads.items()}
    optim.adam_step(field, grads, state.opt,
                    optim.field_lrs(opt_cfg, spatial_scale, state.step))
    g_m2d = (m2d_offset.grad if m2d_offset.grad is not None
             else torch.zeros_like(m2d_offset))
    stats = densify.apply_stats(state.stats, *densify.stats_contribution(
        g_m2d, out.radii, cam.height, cam.width))
    metrics = {
        "loss": loss.detach(), "l1": ll1.detach(),
        "normal_loss": nloss.detach(), "num_dropped": out.num_dropped,
        "num_needed": out.num_needed, "num_needed_raw": out.num_needed_raw,
    }
    return TrainState(field=field, opt=state.opt, stats=stats,
                      step=state.step + 1), metrics


@dataclasses.dataclass
class Trainer:
    """Host-side training of one static scene, on `device` (default: the
    card; the scene's field must live there)."""

    cfg: VegsConfig
    scene: Scene
    raster_cfg: RasterizeConfig = None
    rng_seed: int = 7
    device: object = None

    K_CAP_MIN = 1 << 15            # never shrink below 32k slots
    # Ceiling of both capacities (2^26 slots): the raw stream's per-slot
    # record gather alone is 2 GiB there. At the ceiling a frame that needs
    # more drops instances (num_dropped > 0 in the metrics) instead of
    # doubling without bound.
    K_CAP_MAX = 1 << 26
    K_CAP_DECAY_WINDOW = 200       # steps of <25% utilization before halving

    def __post_init__(self):
        cfg = self.cfg
        self.device = resolve_device(self.device)
        f = self.scene.gaussians
        if f.means.device.type != self.device.type:
            raise ValueError(f"the scene's field lies on {f.means.device}, "
                             f"the trainer runs on {self.device}")
        if self.raster_cfg is None:
            self.raster_cfg = RasterizeConfig(
                backend=cfg.pipeline.backend, k_cap=cfg.pipeline.k_cap,
                clamp_radius=cfg.pipeline.clamp_radius)
        self.rng = np.random.default_rng(self.rng_seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.rng_seed)
        self.spatial_scale = float(self.scene.cameras_extent)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
            device=self.device)
        self.state = TrainState(
            field=f, opt=optim.adam_init(f),
            stats=DensifyStats.zeros(f.capacity, self.device), step=0)
        self.viewpoint_stack = []
        self.metrics_log = []

    # -- helpers -----------------------------------------------------------
    def _next_camera(self):
        if not self.viewpoint_stack:
            self.viewpoint_stack = list(self.scene.getTrainCameras())
        idx = self.rng.integers(len(self.viewpoint_stack))
        return self.viewpoint_stack.pop(int(idx))

    def _active_sh_degree(self, it: int) -> int:
        # SH warm-up: one band every 1000 iterations
        return min(it // 1000, self.cfg.model.sh_degree)

    def _adapt_k_cap(self, num_dropped: float, num_needed: float = 0.0,
                     num_needed_raw: float = 0.0) -> None:
        """Grow both capacities 2x (up to K_CAP_MAX) when instances are
        dropped; halve each (down to K_CAP_MIN) once its need stayed under
        25% for K_CAP_DECAY_WINDOW consecutive steps. k_cap tracks the raw
        stream (num_needed_raw), k_pad the padded layout (num_needed)."""
        if num_needed_raw <= 0:
            num_needed_raw = num_needed
        if num_dropped > 0:
            k_pad = self.raster_cfg.k_pad or self.raster_cfg.k_cap
            self.raster_cfg = self.raster_cfg._replace(
                k_cap=min(self.raster_cfg.k_cap * 2, self.K_CAP_MAX),
                k_pad=min(k_pad * 2, self.K_CAP_MAX))
            self._kcap_low_streak = 0
            self._kpad_low_streak = 0
            return
        if num_needed_raw > 0 and num_needed_raw < 0.25 * self.raster_cfg.k_cap:
            self._kcap_low_streak = getattr(self, "_kcap_low_streak", 0) + 1
        else:
            self._kcap_low_streak = 0
        if (self._kcap_low_streak >= self.K_CAP_DECAY_WINDOW
                and self.raster_cfg.k_cap // 2 >= self.K_CAP_MIN):
            self.raster_cfg = self.raster_cfg._replace(
                k_cap=self.raster_cfg.k_cap // 2)
            self._kcap_low_streak = 0
        k_pad = self.raster_cfg.k_pad or self.raster_cfg.k_cap
        if num_needed > 0 and num_needed < 0.25 * k_pad:
            self._kpad_low_streak = getattr(self, "_kpad_low_streak", 0) + 1
        else:
            self._kpad_low_streak = 0
        if (self._kpad_low_streak >= self.K_CAP_DECAY_WINDOW
                and k_pad // 2 >= self.K_CAP_MIN):
            self.raster_cfg = self.raster_cfg._replace(k_pad=k_pad // 2)
            self._kpad_low_streak = 0

    # -- one iteration ------------------------------------------------------
    def train_iteration(self, it: int, camera=None) -> dict:
        cam = camera if camera is not None else self._next_camera()
        gt = torch.from_numpy(
            np.asarray(cam.original_image, np.float32)).to(self.device)
        wn = cam.world_normal()
        normal = (torch.from_numpy(np.asarray(wn, np.float32)).to(self.device)
                  if wn is not None else torch.zeros_like(gt))
        normal_valid = 0.0 if wn is None else 1.0
        self.state, metrics = train_step(
            self.state, cam.device_params(self.device), gt, normal,
            normal_valid, self._active_sh_degree(it), self.bg,
            opt_cfg=self.cfg.opt, raster_cfg=self.raster_cfg,
            spatial_scale=self.spatial_scale,
            sh_total_degree=self.cfg.model.sh_degree)
        metrics = {k: float(v) for k, v in metrics.items()}
        self._adapt_k_cap(metrics["num_dropped"], metrics["num_needed"],
                          metrics["num_needed_raw"])
        self._densify_and_reset(it)
        return metrics

    def _densify_and_reset(self, it: int) -> None:
        o = self.cfg.opt
        max_screen = 20 if it > o.opacity_reset_interval else 0
        densify_now = (it % o.densification_interval == 0
                       and it > o.densify_from_iter)
        reset_now = (it % o.opacity_reset_interval == 0 and it > 0) or (
            self.cfg.model.white_background and it == o.densify_from_iter)
        if it > o.densify_until_iter:
            return
        st = self.state
        if densify_now:
            f, opt, stats, _ = densify.densify_and_prune(
                st.field, st.opt, st.stats, self.generator,
                grad_threshold=o.densify_grad_threshold,
                percent_dense=o.percent_dense, extent=self.spatial_scale,
                max_screen_size=max_screen)
            self.state = TrainState(field=f, opt=opt, stats=stats, step=st.step)
            self.scene.gaussians = f
        if reset_now:
            f, opt = densify.reset_opacity(self.state.field, self.state.opt)
            self.state = TrainState(field=f, opt=opt, stats=self.state.stats,
                                    step=self.state.step)

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, cameras=None, max_cams: Optional[int] = None,
                 with_ssim: bool = False) -> dict:
        """PSNR/L1 (and SSIM) of the static field over `cameras` (default:
        the held-out split)."""
        cams = cameras if cameras is not None else self.scene.getTestCameras()
        if max_cams is not None:
            cams = cams[:max_cams]
        if not cams:
            return {}
        deg = self.cfg.model.sh_degree
        cfg = self.raster_cfg._replace(forward_only=True)
        psnrs, l1s, ssims = [], [], []
        for cam in cams:
            out = _run(cam.device_params(self.device),
                       field_arrays(self.state.field, deg), bg=self.bg,
                       scale_modifier=1.0, override_color=None, sh_degree=deg,
                       config=cfg, means2d_offset=None)
            gt = torch.from_numpy(
                np.asarray(cam.original_image, np.float32)).to(self.device)
            rgb = torch.clamp(out.rgb, 0.0, 1.0)
            psnrs.append(float(psnr(rgb, gt)))
            l1s.append(float(l1_loss(rgb, gt)))
            if with_ssim:
                ssims.append(float(ssim(rgb, gt)))
        res = {"psnr": float(np.mean(psnrs)), "l1": float(np.mean(l1s)),
               "n_cams": len(cams)}
        if with_ssim:
            res["ssim"] = float(np.mean(ssims))
        return res

    def train(self, iterations: Optional[int] = None, log_every: int = 50,
              eval_every: int = 0, logger=None) -> list[dict]:
        """Iterations 1..`iterations` (default cfg.opt.iterations); every
        `log_every` the metrics go to `metrics_log` (and `logger.log(m,
        step=it)` when a logger is given)."""
        total = iterations or self.cfg.opt.iterations
        t0 = time.time()
        for it in range(1, total + 1):
            m = self.train_iteration(it)
            if it % log_every == 0 or it == total:
                m["iter"] = it
                m["elapsed_s"] = round(time.time() - t0, 1)
                m["n_active"] = int(self.state.field.num_active())
                self.metrics_log.append(m)
                if logger:
                    logger.log(m, step=it)
            if eval_every and it % eval_every == 0:
                e = self.evaluate(max_cams=8)
                if e:
                    rec = {"iter": it, **{f"eval_{k}": v for k, v in e.items()}}
                    self.metrics_log.append(rec)
                    if logger:
                        logger.log(rec, step=it)
        return self.metrics_log
