"""Training loop for static and dynamic scenes (port of vegs_tpu/train.py).

One step: render the static field, and the box fields of the frame's
dynamic instances moved to the world by their annotated box-to-world
transforms and learnable residuals (`boxmodel.BoxDeltas`), in one
rasterizer call with a zero means2d tap (`render._run`); score
(1 - lambda) L1 + lambda (1 - SSIM) plus the normal-guidance term and the
deltas' pull toward identity; backpropagate with PyTorch autograd (kernels
K2 and K3 inside the blend's and the gather's backward); take the Adam
steps in place, every one through `optim.adam_step` (the static field at
the scene's extent, each box field at spatial scale 1 with `box_lr_mult`
on its means, each (frame, instance) residual at `boxmodel_lr` with eps
1e-8) and fold the tap's gradient into each part's densify statistics.
Between steps the host adapts the tile-instance capacities and densifies,
prunes and resets opacity on the reference's schedule: the static field
until `densify_until_iter`, the box fields, with half the grad threshold
and screen size, until `densify_until_iter_box`.

Each box instance keeps its own field, Adam state and statistics, and only
the frame's instances are stepped: the JAX package's pooled stack of
padded slots (for one jitted shape and a donated device buffer) serves
JAX's compilation, not the contract. `Trainer.init_from_normals` is the normal-prior
covariance init a run takes before its first step.

Checkpoints (`save_checkpoint`, `load_checkpoint`) hold the JAX Trainer's
tree leaf for leaf, written with `torch.save` to
`model_path/checkpoints/<it>/checkpoint.pt`; a JAX tree converts with
`convert.checkpoint_from_numpy`. `main` is the training CLI (`python -m
vegs_torch.train`, the JAX CLI's flags): read the scene, the normal init,
train, report, save PLYs and checkpoints, resume.

Two optional terms join the step's loss before its one backward, as in
the JAX step (vegs_tpu/train.py:206-228). The VGG perceptual term
(cfg.sd.perceptual_loss) scores the composite render against the ground
truth. Inside the guidance window (a `Trainer.sd_guidance`, built by
`main` from a local Stable-Diffusion checkpoint in $VEGS_SD_CHECKPOINT),
the static field alone is rendered at a randomly augmented camera, with
no means2d tap, so the view adds nothing to the densify statistics; a
square crop of it goes through `losses.sd_guidance.SDGuidance` (the VAE
encoder's backward carries the diffusion prior's gradient into the
render).

Data parallelism (vegs_tpu/train.py:115-402, :811-946): with a `comm`
(`parallel.comm.Comm`, one rank a camera) the same step runs on every rank
against the replicated field, and the ranks meet where the JAX step's
`shard_map` reduces: the static gradients (plus the replicated `g_extra`,
added before the mean) averaged over the ranks; each box instance's
gradients summed and divided by the number of ranks whose frame holds it;
the densify statistics of every view added (norms, visibility) or maxed
(radii); the losses averaged, the capacity signals maxed. The Adam steps
then run the same on every rank. `train_step(comm=...)` is the port's one
data-parallel step, static or with boxes. `Trainer(dp_devices=D)` draws D
cameras a step from the host rng on every rank and trains camera `rank`;
`main --data_parallel D` starts the ranks (`parallel.launch.spawn`).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import boxmodel, convert, densify, geometry, optim, resolve_device
from .boxmodel import BoxDeltas
from .config import VegsConfig
from .gaussians import DensifyStats, GaussianField
from .losses import l1_loss, loss_normal_guidance, psnr, ssim
from .ops.projection import CameraParams
from .ops.rasterize import RasterizeConfig, RasterOut
from .render import BoxInstance, _bounds, _run, field_arrays, render_all
from .scene import Scene, box_matrix
from .utils import trace

CHECKPOINT_FILE = "checkpoint.pt"


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
            raster_cfg: RasterizeConfig, sh_total_degree: int = 3,
            boxes=(), lambda_reg: float = 0.0):
    """The step's loss of the field and the `boxes` (`render.BoxInstance`s
    with deltas) rendered together with the means2d tap `m2d_offset` ([C,
    2] zeros, C the rows of all parts): `image_loss`, plus `lambda_reg` times
    the deltas' pull toward identity when there are boxes. Returns (loss,
    l1, normal_loss, RasterOut)."""
    out, _ = render_all(cam, field, boxes, bg=bg,
                        active_sh_degree=active_sh_degree,
                        sh_degree=sh_total_degree, config=raster_cfg,
                        means2d_offset=m2d_offset)
    with trace.span("train.loss"):
        loss, ll1, nloss = image_loss(out, gt, normal, normal_valid, opt_cfg)
        if boxes:
            # safe norms: at the identity init the plain norm's gradient is NaN,
            # and the NaN guard would then freeze the deltas (boxmodel.safe_norm)
            reg = torch.stack([boxmodel.regularize_loss(b.deltas)
                               for b in boxes]).sum()
            loss = loss + lambda_reg * reg
    return loss, ll1, nloss, out


class GuidedView(NamedTuple):
    """The guidance term of a step: the guidance (an
    `losses.sd_guidance.SDGuidance`), the augmented camera, the first
    column of the square crop, and the generator of the guidance's draws,
    or the draws themselves (`SDGuidance.draw`'s dict), which then replace
    the generator's."""

    guidance: object
    cam: CameraParams
    crop_start: int
    generator: Optional[torch.Generator] = None
    draws: Optional[dict] = None


class Perceptual(NamedTuple):
    """The perceptual term of a step: VGG16's features and the weight."""

    vgg: torch.nn.Module
    lam: float


def guidance_loss(field: GaussianField, guided: GuidedView, iteration: int,
                  active_sh_degree: int, bg, *, raster_cfg: RasterizeConfig,
                  sh_total_degree: int = 3):
    """(loss, RasterOut): the static field rendered at the augmented camera
    without a means2d tap, its h x h crop from column `crop_start` (clamped
    into the frame, as `dynamic_slice` clamps), scored by the guidance at
    `iteration`."""
    with trace.span("aug_render"):
        aug = _run(guided.cam, field_arrays(field, active_sh_degree), bg=bg,
                   scale_modifier=1.0, override_color=None,
                   sh_degree=sh_total_degree, config=raster_cfg,
                   means2d_offset=None)
    h, w = aug.rgb.shape[1:]
    s = min(max(int(guided.crop_start), 0), w - h)
    crop = aug.rgb[:, :, s:s + h]
    return guided.guidance(crop, iteration, generator=guided.generator,
                           draws=guided.draws), aug


@dataclasses.dataclass
class BoxStep:
    """One box instance's state in a step: its field and Adam state
    (updated in place), its densify statistics, its box-to-world transform
    in this frame, and this (frame, instance)'s residual with its Adam
    state (updated in place)."""

    field: GaussianField
    opt: dict
    stats: DensifyStats
    box2world: torch.Tensor   # [4, 4]
    deltas: BoxDeltas
    delta_opt: optim.AdamState
    active: bool = True       # in this rank's frame (data parallel: a box
    #                           of another rank's frame is carried, not
    #                           rendered, and adds zero gradient here)


def train_step(state: TrainState, cam: CameraParams, gt, normal, normal_valid,
               active_sh_degree: int, bg, *, opt_cfg, raster_cfg: RasterizeConfig,
               spatial_scale: float, sh_total_degree: int = 3, boxes=(),
               box_cfg=None, guidance: Optional[GuidedView] = None,
               perceptual: Optional[Perceptual] = None, comm=None,
               g_extra: Optional[dict] = None):
    """One step -> (state, metrics, boxes). The fields' parameters and Adam
    moments, and each active box's residual and its Adam state, are updated
    in place; each `BoxStep` of `boxes` comes back with new statistics
    (`box_cfg`: boxmodel_lr and boxmodel_lambda_reg). With `perceptual`,
    lam times the VGG perceptual loss of the composite render joins the
    loss; with `guidance`, the guidance loss of the static field's
    augmented view at `state.step` (`guidance_loss`). Metrics are 0-d
    tensors on the field's device; the terms add `perceptual_loss`, and
    `guidance_loss` with the augmented render's `aug_num_dropped`,
    `aug_num_needed` and `aug_num_needed_raw`.

    `g_extra` (a gradient per static leaf) is added to the static
    gradients. With `comm` (data parallel, vegs_tpu/train.py:231-339) this
    rank renders `cam` with its active boxes (`boxes` is the union of the
    ranks' instances, the same list on every rank); the static gradients
    (g_extra added first) and the losses are averaged over the ranks, the
    capacity signals maxed, every box's gradients summed and divided by the
    ranks where it is active, the densify contributions added (norms,
    visibility) and maxed (radii); each rank steps its active boxes'
    residuals alone."""
    field = state.field
    live = [b for b in boxes if b.active]
    fields = [field] + [b.field for b in boxes]
    for f in fields:
        for p in f.parameters():
            p.grad = None
    deltas = [BoxDeltas(**{k: v.detach().clone().requires_grad_(True)
                           for k, v in b.deltas.as_dict().items()})
              for b in live]
    insts = [BoxInstance(b.field, b.box2world, d)
             for b, d in zip(live, deltas)]
    bounds = _bounds([field.capacity] + [b.field.capacity for b in live])
    m2d_offset = torch.zeros((bounds[-1], 2), dtype=torch.float32,
                             device=field.means.device, requires_grad=True)
    loss, ll1, nloss, out = loss_fn(
        field, m2d_offset, cam, gt, normal, normal_valid, active_sh_degree,
        bg, opt_cfg=opt_cfg, raster_cfg=raster_cfg,
        sh_total_degree=sh_total_degree, boxes=insts,
        lambda_reg=box_cfg.boxmodel_lambda_reg if boxes else 0.0)
    extra = {}
    if perceptual is not None:
        from .losses.perceptual import vgg_perceptual_loss

        p_loss = vgg_perceptual_loss(perceptual.vgg, out.rgb, gt)
        loss = loss + perceptual.lam * p_loss
        extra["perceptual_loss"] = p_loss.detach()
    if guidance is not None:
        g_loss, aug = guidance_loss(
            field, guidance, state.step, active_sh_degree, bg,
            raster_cfg=raster_cfg, sh_total_degree=sh_total_degree)
        loss = loss + g_loss
        extra.update(guidance_loss=g_loss.detach(),
                     aug_num_dropped=aug.num_dropped,
                     aug_num_needed=aug.num_needed,
                     aug_num_needed_raw=aug.num_needed_raw)
    with trace.span("train.backward"):
        loss.backward()

    with trace.span("train.update"):
        g_static = optim.leaf_grads(field)
        if g_extra is not None:
            g_static = {k: g_static[k] + g_extra[k] for k in g_static}
        metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                   "normal_loss": nloss.detach()}
        caps = {"num_dropped": out.num_dropped, "num_needed": out.num_needed,
                "num_needed_raw": out.num_needed_raw}
        if comm is not None:
            from .parallel.comm import pmax_tree, psum_tree

            n = comm.size
            g_static = {k: v / n for k, v in psum_tree(g_static, comm).items()}
            metrics = {k: v / n for k, v in psum_tree(metrics, comm).items()}
            caps = pmax_tree(caps, comm)
        optim.adam_step(field, g_static, state.opt,
                        optim.field_lrs(opt_cfg, spatial_scale, state.step))
        g_m2d = (m2d_offset.grad if m2d_offset.grad is not None
                 else torch.zeros_like(m2d_offset))
        # one view's contributions for every part at once (they are row-wise),
        # then each part's rows
        norm, vis, rad = densify.stats_contribution(g_m2d, out.radii, cam.height,
                                                    cam.width)

        def part(i):
            a, b = bounds[i], bounds[i + 1]
            return norm[a:b], vis[a:b], rad[a:b]

        # every part's contributions, zero for a box this rank does not render
        contribs = [part(0)]
        live_i = iter(range(1, len(live) + 1))
        for b in boxes:
            if b.active:
                contribs.append(part(next(live_i)))
            else:
                z = torch.zeros(b.field.capacity, dtype=torch.float32,
                                device=field.means.device)
                contribs.append((z, z, z))
        if comm is not None:
            contribs = _reduce_contribs(contribs, comm)
        stats = densify.apply_stats(state.stats, *contribs[0])
        new_boxes = []
        if boxes:
            # box fields live in the unit canonical box: spatial scale 1, the
            # means' rate times box_lr_mult, the static step counter
            with trace.span("boxes.update"):
                box_lrs = optim.field_lrs(opt_cfg, 1.0, state.step,
                                          xyz_lr_mult=opt_cfg.box_lr_mult)
                g_boxes = [optim.leaf_grads(b.field) for b in boxes]
                if comm is not None:
                    g_boxes = _box_grad_means(g_boxes, boxes, comm)
                live_deltas = iter(deltas)
                for b, g, c in zip(boxes, g_boxes, contribs[1:]):
                    optim.adam_step(b.field, g, b.opt, box_lrs)
                    if b.active:  # this rank's frame's residual, stepped here
                        g_d = {k: torch.nan_to_num(v.grad, nan=0.0)  # NaN guard
                               for k, v in next(live_deltas).as_dict().items()}
                        optim.adam_step(b.deltas, g_d, b.delta_opt,
                                        box_cfg.boxmodel_lr, eps=1e-8)
                    new_boxes.append(dataclasses.replace(
                        b, stats=densify.apply_stats(b.stats, *c)))
    metrics = {**metrics, **caps, **extra}
    return (TrainState(field=field, opt=state.opt, stats=stats,
                       step=state.step + 1), metrics, new_boxes)


def _pack_delta(b: BoxStep) -> torch.Tensor:
    """A box's residual and its Adam state as one float32 row [31]."""
    o = b.delta_opt
    parts = [b.deltas.as_dict()[k] for k in BoxDeltas.LEAVES]
    parts += [o["mu"][k] for k in BoxDeltas.LEAVES]
    parts += [o["nu"][k] for k in BoxDeltas.LEAVES]
    dev = parts[0].device
    parts.append(o["count"].to(device=dev, dtype=torch.float32).reshape(1))
    return torch.cat([p.reshape(-1).float() for p in parts])


def _unpack_delta(row: torch.Tensor):
    """Inverse of `_pack_delta` -> (BoxDeltas, its Adam state)."""
    sizes = (4, 3, 3)
    d = dict(zip(BoxDeltas.LEAVES, row[:10].split(sizes)))
    mu = dict(zip(BoxDeltas.LEAVES, row[10:20].split(sizes)))
    nu = dict(zip(BoxDeltas.LEAVES, row[20:30].split(sizes)))
    count = torch.tensor(int(row[30]), dtype=torch.int32)
    return BoxDeltas(**{k: v.clone() for k, v in d.items()}), \
        optim.AdamState(mu={k: v.clone() for k, v in mu.items()},
                        nu={k: v.clone() for k, v in nu.items()},
                        count=count)


def _reduce_contribs(contribs: list, comm) -> list:
    """Every part's (norm, vis, radii) summed (norm, vis) and maxed (radii)
    over the ranks, in two collectives."""
    from .parallel.comm import pmax, psum

    sizes = [c[0].shape[0] for c in contribs]
    summed = psum(torch.cat([torch.cat([c[0] for c in contribs]),
                             torch.cat([c[1] for c in contribs])]), comm)
    rad = pmax(torch.cat([c[2] for c in contribs]), comm)
    n = sum(sizes)
    norm, vis = summed[:n].split(sizes), summed[n:].split(sizes)
    return list(zip(norm, vis, rad.split(sizes)))


def _box_grad_means(g_boxes: list, boxes, comm) -> list:
    """Each box's gradients summed over the ranks and divided by the count
    of ranks whose frame holds it (vegs_tpu/train.py:300-305): a box seen by
    2 of D cameras averages over 2, as 2 sequential steps would."""
    from .parallel.comm import psum, psum_tree

    dev = boxes[0].field.means.device
    act = psum(torch.tensor([float(b.active) for b in boxes], device=dev),
               comm)
    flat = psum_tree({f"{i}/{k}": v for i, g in enumerate(g_boxes)
                      for k, v in g.items()}, comm)
    return [{k: flat[f"{i}/{k}"] / torch.clamp(act[i], min=1.0)
             for k in optim.PARAM_LEAVES} for i in range(len(boxes))]


def _param_grads(loss, field: GaussianField) -> dict:
    """d loss / d each static leaf, zeros where none flows."""
    params = [getattr(field, k) for k in optim.PARAM_LEAVES]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for k, p, g in zip(optim.PARAM_LEAVES, params, grads)}


def guidance_grads(field: GaussianField, guided: GuidedView, iteration: int,
                   bg, *, raster_cfg: RasterizeConfig, sh_degree: int = 3):
    """(loss, gradient per static leaf) of the guidance term alone: the
    field at every SH band, rendered at the augmented camera, its crop
    scored at `iteration` (vegs_tpu/train.py:405 `make_guidance_grad_fn`,
    which the data-parallel step adds through `g_extra`)."""
    loss, _ = guidance_loss(field, guided, iteration, sh_degree, bg,
                            raster_cfg=raster_cfg, sh_total_degree=sh_degree)
    return loss.detach(), _param_grads(loss, field)


def perceptual_grads(field: GaussianField, perceptual: Perceptual,
                     cam: CameraParams, gt, bg, *,
                     raster_cfg: RasterizeConfig, sh_degree: int = 3):
    """(loss, gradient per static leaf) of lam * the VGG perceptual loss of
    the field's render at every SH band against `gt`, without boxes
    (vegs_tpu/train.py:432 `make_perceptual_grad_fn`, whose loss is also
    lam times the perceptual loss)."""
    from .losses.perceptual import vgg_perceptual_loss

    out = _run(cam, field_arrays(field, sh_degree), bg=bg, scale_modifier=1.0,
               override_color=None, sh_degree=sh_degree, config=raster_cfg,
               means2d_offset=None)
    p_loss = perceptual.lam * vgg_perceptual_loss(perceptual.vgg, out.rgb, gt)
    return p_loss.detach(), _param_grads(p_loss, field)


class Staging:
    """A host buffer, reused from copy to copy, through which arrays go to
    `device` in one copy that does not block the host. On a card the
    buffer is pinned, and a timing-free event recorded behind each copy is
    awaited before the buffer is filled again, so a copy still reading it
    is never overwritten."""

    def __init__(self, device):
        self.device = device
        self.buf = torch.empty(0)
        self.copied = (torch.cuda.Event() if device.type == "cuda"
                       else None)

    def send(self, *arrays) -> list:
        """The `arrays` (numpy, any layout) on the device as float32
        tensors of their shapes, in one copy."""
        arrays = [np.asarray(a) for a in arrays]
        sizes = [a.size for a in arrays]
        total = sum(sizes)
        if self.copied is not None:
            self.copied.synchronize()  # at once unless the last copy runs
        if self.buf.numel() < total:
            self.buf = torch.empty(total, dtype=torch.float32,
                                   pin_memory=self.copied is not None)
        host, at = self.buf[:total], 0
        for a, k in zip(arrays, sizes):  # torch's copy runs on its threads
            host[at:at + k].view(a.shape).copy_(torch.from_numpy(a))
            at += k
        dev = host.to(self.device, non_blocking=True, copy=True)
        if self.copied is not None:
            self.copied.record(torch.cuda.current_stream(self.device))
        return [t.view(a.shape) for t, a in zip(dev.split(sizes), arrays)]


@dataclasses.dataclass
class Trainer:
    """Host-side training of one scene, its static field and its box
    fields, on `device` (default: the card; the scene's fields must live
    there). A step renders at most `max_box_slots` of the frame's
    instances. `sd_guidance` (an `SDGuidance`) adds the guidance term
    inside cfg.sd's window (start_guiding_from_iter < it <
    end_guiding_at_iter), its draws from `guidance_generator`;
    cfg.sd.perceptual_loss adds the VGG perceptual term, with the VGG16
    features from the .npz at $VEGS_VGG_WEIGHTS or a random init (seed
    0).

    Data parallel (`dp_devices` > 1, or a `comm`: this rank's
    `parallel.comm.Comm` of dp_devices ranks; by default the data axis of
    the running process group): every rank holds the whole state and
    steps with camera `rank` of the dp_devices cameras that every rank
    draws alike (`_train_iteration_dp`)."""

    cfg: VegsConfig
    scene: Scene
    raster_cfg: RasterizeConfig = None
    max_box_slots: int = 8
    rng_seed: int = 7
    device: object = None
    sd_guidance: object = None
    dp_devices: int = 1
    comm: object = None

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
        if self.comm is None and self.dp_devices > 1:
            from .parallel.mesh import make_mesh

            self.comm = make_mesh(self.dp_devices).comm()
        if self.comm is not None and self.comm.size != self.dp_devices:
            raise ValueError(f"dp_devices={self.dp_devices} on a data axis "
                             f"of {self.comm.size} ranks")
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
        # the guidance's draws have their own stream, as the JAX Trainer's
        # key serves only them
        self.guidance_generator = torch.Generator(device=self.device)
        self.guidance_generator.manual_seed(self.rng_seed)
        self.spatial_scale = float(self.scene.cameras_extent)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
            device=self.device)
        self.state = TrainState(
            field=f, opt=optim.adam_init(f),
            stats=DensifyStats.zeros(f.capacity, self.device), step=0)

        # dynamic objects: a field, Adam state and statistics per instance;
        # a residual and its Adam per (frame, instance), made when first seen
        self.instances = list(self.scene.box_gaussians.keys())
        self.box_fields = dict(self.scene.box_gaussians)
        for k, bf in self.box_fields.items():
            if bf.means.device.type != self.device.type:
                raise ValueError(f"box field {k} lies on {bf.means.device}, "
                                 f"the trainer runs on {self.device}")
        self.box_opts = {k: optim.adam_init(v)
                         for k, v in self.box_fields.items()}
        self.box_stats = {k: DensifyStats.zeros(v.capacity, self.device)
                          for k, v in self.box_fields.items()}
        self.frame_deltas: dict = {}      # (frame, inst) -> BoxDeltas
        self.frame_delta_opts: dict = {}  # (frame, inst) -> optim.AdamState
        self._vgg = None
        if cfg.sd.perceptual_loss:
            from .losses import vgg as vgg_lib

            wpath = os.environ.get("VEGS_VGG_WEIGHTS")
            if wpath and os.path.exists(wpath):
                self._vgg = vgg_lib.load_npz(wpath, device=self.device)
            else:
                # random features still regularize texture statistics
                g = torch.Generator(device=self.device)
                g.manual_seed(0)
                self._vgg = vgg_lib.init_params(g)
        self.viewpoint_stack = []
        self.metrics_log = []
        # the ground truth's and the normal map's (with its rotation)
        self.staging = (Staging(self.device), Staging(self.device))

    # -- helpers -----------------------------------------------------------
    def _next_camera(self):
        if not self.viewpoint_stack:
            self.viewpoint_stack = list(self.scene.getTrainCameras())
        idx = self.rng.integers(len(self.viewpoint_stack))
        return self.viewpoint_stack.pop(int(idx))

    def _active_sh_degree(self, it: int) -> int:
        # SH warm-up: one band every 1000 iterations
        return min(it // 1000, self.cfg.model.sh_degree)

    def _frame_boxes(self, frame: int) -> dict:
        return self.scene.train_bboxes.get(int(frame), {})

    def init_from_normals(self, cameras=None) -> int:
        """The normal-prior covariance init a run takes before its first
        step: every camera of `cameras` (default: the training cameras)
        that has a normal map votes for the rotations of the static
        Gaussians it sees, which then get flattened scales
        (`priors.norminit`). Returns the number of Gaussians initialized."""
        from .priors import norminit

        cams = cameras if cameras is not None else self.scene.getTrainCameras()
        cams = [c for c in cams if c.normal_path or c.normal is not None]
        if not cams:
            return 0
        field = self.state.field
        acc = norminit.accumulate_cameras(field, cams)
        norminit.finalize_normal_init(field, acc)
        return int((acc.count > 0).sum())

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

    def _step_extras(self, it: int, cam):
        """(GuidedView or None, Perceptual or None) of iteration `it` on
        camera `cam`. In the guidance window the augmented camera and the
        crop's start are drawn from `rng` as the JAX Trainer draws them:
        `augment_camera`, then the start (in the half the yaw turned
        toward, unless cfg.sd.global_crop)."""
        sd = self.cfg.sd
        guided = None
        if (self.sd_guidance is not None
                and sd.start_guiding_from_iter < it < sd.end_guiding_at_iter):
            from .scene.cameras import augment_camera

            cam_aug, _, _, _, aug_dir = augment_camera(cam, sd, self.rng)
            span = max(cam_aug.image_width - cam_aug.image_height, 1)
            if sd.global_crop or aug_dir is None:
                crop_start = int(self.rng.integers(0, span))
            elif aug_dir == -1:  # looking right: the right half
                crop_start = int(self.rng.integers(span // 2, span))
            else:
                crop_start = int(self.rng.integers(0, max(span // 2, 1)))
            guided = GuidedView(self.sd_guidance,
                                cam_aug.device_params(self.device),
                                crop_start, self.guidance_generator)
        perceptual = None
        if self._vgg is not None:
            perceptual = Perceptual(self._vgg.requires_grad_(False),
                                    sd.perceptual_loss_lambda)
        return guided, perceptual

    # -- one iteration ------------------------------------------------------
    def _box_steps(self, frame: int) -> tuple[list, list]:
        """(instances, `BoxStep`s) of the frame's instances that have a
        field, at most max_box_slots, with every box-to-world matrix sent to
        the device in one copy."""
        boxes = self._frame_boxes(frame)
        insts = [i for i in boxes if i in self.box_fields][: self.max_box_slots]
        if not insts:
            return [], []
        with trace.span("boxes.copy", sync=True):
            b2w = torch.from_numpy(np.stack(
                [box_matrix(boxes[i]) for i in insts]).astype(np.float32)
            ).to(self.device)
        steps = []
        for j, inst in enumerate(insts):
            key = (frame, inst)
            if key not in self.frame_deltas:
                self.frame_deltas[key] = BoxDeltas.identity(device=self.device)
                self.frame_delta_opts[key] = optim.adam_init(
                    self.frame_deltas[key].as_dict())
            steps.append(BoxStep(
                field=self.box_fields[inst], opt=self.box_opts[inst],
                stats=self.box_stats[inst], box2world=b2w[j],
                deltas=self.frame_deltas[key],
                delta_opt=self.frame_delta_opts[key]))
        return insts, steps

    def _targets(self, cam):
        """(gt, normal, normal_valid) of a camera on the device: the image,
        and the camera-space normal map with the camera's rotation, each
        sent through its staging buffer; the normals rotated to world
        space there in float32 (`Camera.world_normal`'s product)."""
        # sync: each waits for its buffer's previous copy
        with trace.span("targets.copy", sync=True):
            (gt,) = self.staging[0].send(cam.original_image)
        n = cam.original_normal
        if n is None:
            return gt, torch.zeros_like(gt), 0.0
        with trace.span("targets.copy", sync=True):
            n, r_c2w = self.staging[1].send(n, cam.R)
        with trace.span("targets.normal"):
            trace.count("targets.normal_device")
            normal = geometry.cam_normal_to_world_normal(
                n.reshape(3, -1).T, r_c2w).T.reshape(n.shape)
        return gt, normal, 1.0

    def train_iteration(self, it: int, camera=None) -> dict:
        with trace.span("train.step"):
            if self.comm is not None:
                # an explicit camera is repeated over the ranks: the mean of D
                # equal gradients is the camera's gradient, and the densify
                # statistics count it D times in accum and denom alike
                cams = None if camera is None else [camera] * self.dp_devices
                return self._train_iteration_dp(it, cameras=cams)
            cam = camera if camera is not None else self._next_camera()
            with trace.span("train.targets"):
                gt, normal, normal_valid = self._targets(cam)
                params = cam.device_params(self.device)
            frame = int(getattr(cam, "frame", 0))
            with trace.span("train.boxes"):
                insts, box_steps = self._box_steps(frame)
            guided, perceptual = self._step_extras(it, cam)
            self.state, metrics, stepped = train_step(
                self.state, params, gt, normal,
                normal_valid, self._active_sh_degree(it), self.bg,
                opt_cfg=self.cfg.opt, raster_cfg=self.raster_cfg,
                spatial_scale=self.spatial_scale,
                sh_total_degree=self.cfg.model.sh_degree,
                boxes=box_steps, box_cfg=self.cfg.box, guidance=guided,
                perceptual=perceptual)
            for inst, b in zip(insts, stepped):
                self.box_stats[inst] = b.stats
            return self._end_step(it, metrics)

    def _end_step(self, it: int, metrics: dict) -> dict:
        """Read the step's metrics to the host, adapt the capacities and
        densify on schedule; the metrics as floats."""
        with trace.span("train.read", sync=True):
            metrics = {k: float(v) for k, v in metrics.items()}
        with trace.span("train.kcap"):
            self._adapt_k_cap(metrics["num_dropped"], metrics["num_needed"],
                              metrics["num_needed_raw"])
        with trace.span("train.densify"):
            self._densify_and_reset(it)
        return metrics

    def _train_iteration_dp(self, it: int, cameras=None) -> dict:
        """One data-parallel iteration (vegs_tpu/train.py:811-946): D
        cameras drawn alike on every rank, this rank's (`comm.index`)
        trained. Box slots are the union of the D frames' instances (at
        most max_box_slots), in first-seen order. The guidance term (one
        augmented view of the first camera, in the window) and the
        perceptual term (the first camera) are computed on rank 0 and
        broadcast, then added to every rank's static gradient before the
        mean. Each rank steps its own frame's residuals; they are then
        all-gathered and written back rank by rank, so on a key two ranks
        share (an explicit camera repeated) the highest rank's wins, on
        every rank."""
        from .parallel.comm import all_gather

        comm, D = self.comm, self.dp_devices
        cams = (list(cameras) if cameras is not None
                else [self._next_camera() for _ in range(D)])
        if len(cams) != D:
            raise ValueError(f"need {D} cameras, got {len(cams)}")
        me = comm.index
        cam = cams[me]
        with trace.span("train.targets"):
            gt, normal, normal_valid = self._targets(cam)
            params = cam.device_params(self.device)
        frames = [int(getattr(c, "frame", 0)) for c in cams]
        per_cam = [self._frame_boxes(f) for f in frames]
        union = []
        for boxes in per_cam:
            for inst in boxes:
                if inst in self.box_fields and inst not in union:
                    union.append(inst)
        union = union[: self.max_box_slots]
        mine = per_cam[me]
        steps = []
        for inst in union:
            active = inst in mine
            key = (frames[me], inst)
            if active and key not in self.frame_deltas:
                self.frame_deltas[key] = BoxDeltas.identity(device=self.device)
                self.frame_delta_opts[key] = optim.adam_init(
                    self.frame_deltas[key].as_dict())
            if active:
                with trace.span("boxes.copy", sync=True):
                    b2w = torch.from_numpy(
                        box_matrix(mine[inst]).astype(np.float32)).to(
                            self.device)
            else:
                b2w = torch.eye(4, device=self.device)
            deltas = (self.frame_deltas[key] if active
                      else BoxDeltas.identity(device=self.device))
            dopt = (self.frame_delta_opts[key] if active
                    else optim.adam_init(deltas.as_dict()))
            steps.append(BoxStep(
                field=self.box_fields[inst], opt=self.box_opts[inst],
                stats=self.box_stats[inst], box2world=b2w, deltas=deltas,
                delta_opt=dopt, active=active))

        extra_metrics, g_extra = self._dp_extras(it, cams[0])
        self.state, metrics, stepped = train_step(
            self.state, params, gt, normal,
            normal_valid, self._active_sh_degree(it), self.bg,
            opt_cfg=self.cfg.opt, raster_cfg=self.raster_cfg,
            spatial_scale=self.spatial_scale,
            sh_total_degree=self.cfg.model.sh_degree, boxes=steps,
            box_cfg=self.cfg.box, comm=comm, g_extra=g_extra)
        for inst, b in zip(union, stepped):
            self.box_stats[inst] = b.stats
        if union:
            # every rank's stepped residuals [D, S, 31] (deltas, both Adam
            # moments, the count), written back in rank order
            rows = torch.stack([_pack_delta(b) for b in stepped])
            packed = all_gather(rows[None], comm)
            for d in range(D):
                for si, inst in enumerate(union):
                    if inst in per_cam[d]:
                        self.frame_deltas[(frames[d], inst)], \
                            self.frame_delta_opts[(frames[d], inst)] = \
                            _unpack_delta(packed[d, si])
        return self._end_step(it, {**metrics, **extra_metrics})

    def _dp_extras(self, it: int, cam0):
        """(metrics, g_extra) of the data-parallel step's optional terms,
        computed on rank 0 and broadcast (a UNet run on two ranks need not
        give the same bits): in the guidance window one augmented view of
        the first camera, its crop start drawn over the whole span
        (vegs_tpu/train.py:904-917; every rank draws, so the host rngs stay
        alike), scored at iteration `it`; the perceptual term of the first
        camera's render."""
        from .parallel.comm import broadcast_tree

        sd = self.cfg.sd
        deg = self.cfg.model.sh_degree
        guided = None
        if (self.sd_guidance is not None
                and sd.start_guiding_from_iter < it < sd.end_guiding_at_iter):
            from .scene.cameras import augment_camera

            cam_aug, *_ = augment_camera(cam0, sd, self.rng)
            span = max(cam_aug.image_width - cam_aug.image_height, 1)
            crop_start = int(self.rng.integers(0, span))
            guided = GuidedView(self.sd_guidance,
                                cam_aug.device_params(self.device),
                                crop_start, self.guidance_generator)
        if guided is None and self._vgg is None:
            return {}, None
        field = self.state.field
        zero = {k: torch.zeros_like(getattr(field, k))
                for k in optim.PARAM_LEAVES}
        g_extra = dict(zero)
        metrics = {}
        if self.comm.index == 0:
            if guided is not None:
                metrics["guidance_loss"], g = guidance_grads(
                    field, guided, it, self.bg, raster_cfg=self.raster_cfg,
                    sh_degree=deg)
                g_extra = {k: g_extra[k] + g[k] for k in g_extra}
            if self._vgg is not None:
                gt0 = self._targets(cam0)[0]
                metrics["perceptual_loss"], g = perceptual_grads(
                    field, Perceptual(self._vgg.requires_grad_(False),
                                      sd.perceptual_loss_lambda),
                    cam0.device_params(self.device), gt0, self.bg,
                    raster_cfg=self.raster_cfg, sh_degree=deg)
                g_extra = {k: g_extra[k] + g[k] for k in g_extra}
        else:
            if guided is not None:
                metrics["guidance_loss"] = torch.zeros((), device=self.device)
            if self._vgg is not None:
                metrics["perceptual_loss"] = torch.zeros((),
                                                         device=self.device)
        sent = broadcast_tree({**{f"g/{k}": v for k, v in g_extra.items()},
                               **{f"m/{k}": v.reshape(()).float()
                                  for k, v in metrics.items()}}, self.comm)
        g_extra = {k: sent[f"g/{k}"] for k in optim.PARAM_LEAVES}
        return {k: sent[f"m/{k}"] for k in metrics}, g_extra

    def _densify_and_reset(self, it: int) -> None:
        """Densify and prune, and reset opacities, on the reference's
        schedule: the static field while it <= densify_until_iter; every
        box field while it <= densify_until_iter_box, with half the grad
        threshold and half the screen size, at the same extent."""
        o = self.cfg.opt
        max_screen = 20 if it > o.opacity_reset_interval else 0
        densify_now = (it % o.densification_interval == 0
                       and it > o.densify_from_iter)
        reset_now = (it % o.opacity_reset_interval == 0 and it > 0) or (
            self.cfg.model.white_background and it == o.densify_from_iter)
        parts = []  # (instance or None for the static field, threshold, screen)
        if it <= o.densify_until_iter:
            parts.append((None, o.densify_grad_threshold, max_screen))
        if it <= o.densify_until_iter_box:
            parts += [(inst, o.densify_grad_threshold * 0.5, max_screen // 2)
                      for inst in self.box_fields]
        for inst, threshold, screen in parts:
            if inst is None:
                f, opt, stats = self.state.field, self.state.opt, self.state.stats
            else:
                f, opt = self.box_fields[inst], self.box_opts[inst]
                stats = self.box_stats[inst]
            if densify_now:
                f, opt, stats, _ = densify.densify_and_prune(
                    f, opt, stats, self.generator, grad_threshold=threshold,
                    percent_dense=o.percent_dense, extent=self.spatial_scale,
                    max_screen_size=screen)
            if reset_now:
                f, opt = densify.reset_opacity(f, opt)
            if inst is None:
                self.state = TrainState(field=f, opt=opt, stats=stats,
                                        step=self.state.step)
                self.scene.gaussians = f
            else:
                self.box_fields[inst], self.box_opts[inst] = f, opt
                self.box_stats[inst] = stats

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, cameras=None, max_cams: Optional[int] = None,
                 with_boxes: bool = False, with_ssim: bool = False) -> dict:
        """PSNR/L1 (and SSIM) over `cameras` (default: the held-out split).
        With `with_boxes=True` each frame's dynamic instances (train and
        test annotations), with their learned residuals, are composited
        into the render (`render_all`)."""
        cams = cameras if cameras is not None else self.scene.getTestCameras()
        if max_cams is not None:
            cams = cams[:max_cams]
        if not cams:
            return {}
        deg = self.cfg.model.sh_degree
        cfg = self.raster_cfg._replace(forward_only=True)
        box_fields = self.box_fields if with_boxes else {}
        psnrs, l1s, ssims = [], [], []
        for cam in cams:
            frame = int(getattr(cam, "frame", 0))
            boxes = {}
            if with_boxes:
                boxes = dict(self.scene.train_bboxes.get(frame, {}))
                boxes.update(self.scene.test_bboxes.get(frame, {}))
            insts = [BoxInstance(
                field=box_fields[i],
                box2world=torch.from_numpy(
                    box_matrix(m).astype(np.float32)).to(self.device),
                deltas=self.frame_deltas.get((frame, i)))
                for i, m in boxes.items() if i in box_fields]
            cam_p = cam.device_params(self.device)
            if insts:
                out, _ = render_all(cam_p, self.state.field, insts, bg=self.bg,
                                    active_sh_degree=deg, sh_degree=deg,
                                    config=cfg)
            else:
                out = _run(cam_p, field_arrays(self.state.field, deg),
                           bg=self.bg, scale_modifier=1.0, override_color=None,
                           sh_degree=deg, config=cfg, means2d_offset=None)
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

    # -- checkpoints ----------------------------------------------------------
    def _checkpoint_tree(self) -> dict:
        """The JAX Trainer's checkpoint tree with the same keys and leaf
        names, as CPU tensors: the static field, its Adam state (the
        moments carry the field's `valid`, as the JAX moments do), stats
        and step; each box instance's field, Adam state and stats under
        str(instance); each (frame, instance) residual and its Adam state
        under "<frame>_<instance>". No RNG state and no adaptive capacity
        is saved (the JAX package saves neither)."""
        def cpu(t):
            return t.detach().to("cpu", copy=True)

        def field(f):
            return {k: cpu(getattr(f, k)) for k in convert.FIELD_KEYS}

        def adam(o, f):
            valid = cpu(f.valid)
            return {**{m: {**{k: cpu(o[m][k]) for k in optim.PARAM_LEAVES},
                           "valid": valid} for m in ("mu", "nu")},
                    "count": cpu(o["count"])}

        def stats(st):
            return {k: cpu(getattr(st, k)) for k in convert.STATS_KEYS}

        def delta_adam(o):
            return {"mu": {k: cpu(v) for k, v in o["mu"].items()},
                    "nu": {k: cpu(v) for k, v in o["nu"].items()},
                    "count": cpu(o["count"])}

        st = self.state
        return {
            "state": {"field": field(st.field), "opt": adam(st.opt, st.field),
                      "stats": stats(st.stats),
                      "step": torch.tensor(int(st.step), dtype=torch.int32)},
            "boxes": {str(k): {"field": field(f),
                               "opt": adam(self.box_opts[k], f),
                               "stats": stats(self.box_stats[k])}
                      for k, f in self.box_fields.items()},
            "deltas": {f"{fr}_{i}": {
                "deltas": {k: cpu(v) for k, v in d.as_dict().items()},
                "opt": delta_adam(self.frame_delta_opts[(fr, i)])}
                for (fr, i), d in self.frame_deltas.items()},
        }

    def checkpoint_path(self, it: int) -> Path:
        return (Path(self.cfg.model.model_path).resolve() / "checkpoints"
                / f"{it}" / CHECKPOINT_FILE)

    def save_checkpoint(self, it: int) -> None:
        path = self.checkpoint_path(it)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save(self._checkpoint_tree(), tmp)
        os.replace(tmp, path)

    def load_checkpoint(self, it: int) -> None:
        """Resume from `save_checkpoint(it)`'s file."""
        tree = torch.load(self.checkpoint_path(it), map_location="cpu",
                          weights_only=True)
        self.restore(convert.checkpoint_from_numpy(tree, device=self.device))

    def restore(self, ckpt: dict) -> None:
        """Take a checkpoint's state (`convert.checkpoint_from_numpy`): the
        static state, and the box fields, Adam states, stats and residuals
        it holds (instances it does not hold keep theirs)."""
        self.state = ckpt["state"]
        self.scene.gaussians = self.state.field
        for name in convert.BOX_STATE_KEYS:
            getattr(self, name).update(ckpt[name])

    # -- reporting and the loop ------------------------------------------------
    @torch.no_grad()
    def training_report(self, it: int, out_dir=None) -> dict:
        """The held-out split's PSNR and L1 (`evaluate`) and, with
        `out_dir`, the first test camera (train, without a test split) at
        the fixed extrapolations of `render_video.DEFAULT_AUG_PARAMS`, with
        its frame's boxes: `iter_<it>/aug_<i>.png` and the covariance-axis
        picture `iter_<it>/rotaxis_<i>.png`, written with PIL. The scene
        renders the Trainer's current fields."""
        from .render_video import (DEFAULT_AUG_PARAMS, render_novelview_image,
                                   render_novelview_rotaxis)

        report = {"iter": it, **{f"test_{k}": v
                                 for k, v in self.evaluate().items()}}
        if out_dir:
            from PIL import Image

            cams = self.scene.getTestCameras() or self.scene.getTrainCameras()
            cam = cams[0]
            boxes = self._frame_boxes(getattr(cam, "frame", 0))
            base = Path(out_dir) / f"iter_{it}"
            base.mkdir(parents=True, exist_ok=True)
            self.scene.gaussians = self.state.field
            self.scene.box_gaussians.update(self.box_fields)
            cfg = self.raster_cfg._replace(forward_only=True)
            for ai, aug in enumerate(DEFAULT_AUG_PARAMS):
                img = render_novelview_image(self.scene, cam, boxes, cfg,
                                             self.bg, aug)
                Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)
                                ).save(base / f"aug_{ai}.png")
                Image.fromarray(render_novelview_rotaxis(
                    self.scene, cam, boxes, cfg, self.bg, aug)
                ).save(base / f"rotaxis_{ai}.png")
        return report

    def train(self, iterations: Optional[int] = None, log_every: int = 50,
              eval_every: int = 0, logger=None) -> list[dict]:
        """Iterations 1..`iterations` (default cfg.opt.iterations); every
        `log_every` the metrics go to `metrics_log` and to `logger.log(m,
        step=it)` (default, when the config has a model_path: a
        `MetricsLogger` there, with the config saved as `cfg_args.json`)."""
        total = iterations or self.cfg.opt.iterations
        if logger is None and self.cfg.model.model_path:
            from .utils.logging import MetricsLogger

            logger = MetricsLogger(self.cfg.model.model_path)
            self.cfg.save(Path(self.cfg.model.model_path) / "cfg_args.json")
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


def _cli_args(argv):
    import argparse

    from .config import parse_config

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--test_iterations", nargs="+", type=int,
                    default=[7_000, 30_000])
    ap.add_argument("--save_iterations", nargs="+", type=int,
                    default=[30_000, 100_000])
    ap.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    ap.add_argument("--start_checkpoint", type=int, default=None)
    ap.add_argument("--iterations_override", type=int, default=None)
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="camera-batch data parallelism: 0 = every local "
                         "card (one rank on the CPU), 1 = one device, N = "
                         "N ranks")
    ap.add_argument("--coordinator_address", type=str, default=None,
                    help="multi-host: host:port where the ranks meet")
    ap.add_argument("--num_processes", type=int, default=None,
                    help="multi-host: ranks in all, one process each")
    ap.add_argument("--process_id", type=int, default=None,
                    help="multi-host: this process's rank")
    extra, rest = ap.parse_known_args(argv)
    return extra, parse_config(rest)


def main(argv=None, device=None) -> Optional[Trainer]:
    """The training CLI, with the JAX CLI's flags: the config groups'
    flags (`config.parse_config`) and --test_iterations,
    --save_iterations, --checkpoint_iterations, --start_checkpoint,
    --iterations_override, --data_parallel, --coordinator_address,
    --num_processes and --process_id. Seeds and timestamps stdout
    (`safe_state`), reads the scene, runs the normal-prior init, resumes
    from --start_checkpoint, trains to the last iteration (logging every
    50th to `model_path/metrics.jsonl`), reports at --test_iterations
    (`model_path/results`), saves PLYs at --save_iterations and at the end
    and checkpoints at --checkpoint_iterations. Returns the Trainer of a
    one-device run (None when it started ranks).

    With $VEGS_SD_CHECKPOINT set (a local Stable-Diffusion checkpoint in
    the diffusers layout; the text encoder needs `transformers`) the
    Trainer gets diffusion guidance (`losses.sd_guidance.build_guidance`),
    with the per-segment LoRA weights of
    lora_model_dir/data_type/seq/<start>_<end> when that directory exists.

    Runs on `device` (default: the card). --data_parallel D > 1 starts D
    local ranks (`parallel.launch.spawn`): one per card under NCCL (D may
    not exceed the cards), or D processes on the CPU under gloo; 0 means
    every local card. Multi-host: every process is one rank, started with
    --coordinator_address host:port, --num_processes (ranks in all) and
    --process_id (its rank); --data_parallel must then be 0 or the rank
    count. Rank 0 alone writes the logs, reports, PLYs and checkpoints,
    and the ranks meet at a barrier after each. `model_path` defaults to
    the working directory, and the KITTI-360 reader writes its point cache
    to `./.cache` (rank 0 reads the scene first), as the JAX CLI does."""
    extra, cfg = _cli_args(argv)
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if extra.coordinator_address is not None or extra.num_processes:
        from .parallel.mesh import initialize_distributed

        n = initialize_distributed(extra.coordinator_address,
                                   extra.num_processes, extra.process_id,
                                   backend=backend)
        if extra.data_parallel not in (0, n):
            raise ValueError(f"--data_parallel {extra.data_parallel} in a "
                             f"world of {n} ranks")
        if dev.type == "cuda":
            dev = torch.device("cuda", extra.process_id
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        return _train_main(extra, cfg, dev, n)
    n_local = torch.cuda.device_count() if dev.type == "cuda" else 1
    dp = extra.data_parallel if extra.data_parallel > 0 else n_local
    if dp == 1:
        return _train_main(extra, cfg, dev, 1)
    import tempfile

    from .parallel.launch import spawn

    with tempfile.TemporaryDirectory() as tmp:
        spawn(_rank_main, dp, list(argv if argv is not None else sys.argv[1:]),
              dev.type, backend=backend,
              init_file=Path(tmp) / "rendezvous")
    return None


def _rank_main(rank: int, argv: list, device_type: str) -> None:
    """One local rank of `main --data_parallel D` (started by `spawn`)."""
    extra, cfg = _cli_args(argv)
    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device(device_type))
    import torch.distributed as dist

    _train_main(extra, cfg, dev, dist.get_world_size())


def _train_main(extra, cfg, dev, dp: int) -> Trainer:
    from .utils.general import safe_state
    from .utils.logging import MetricsLogger

    comm = None
    if dp > 1 or extra.coordinator_address is not None:
        from .parallel.mesh import make_mesh

        comm = make_mesh(dp).comm()
    lead = comm is None or comm.index == 0

    def barrier():
        if comm is not None:
            comm.barrier()

    safe_state(seed=cfg.model.seed)
    if not lead:
        barrier()  # rank 0 reads the scene (and writes ./.cache) first
    scene = Scene(cfg.model, cfg.data, cfg.box, device=dev)
    if lead:
        barrier()
    trainer = Trainer(cfg, scene, rng_seed=cfg.model.seed, device=dev,
                      dp_devices=dp, comm=comm)
    sd_dir = os.environ.get("VEGS_SD_CHECKPOINT")
    if sd_dir:
        from .losses.sd_guidance import build_guidance

        lora_dir = os.path.join(
            cfg.sd.lora_model_dir, cfg.model.data_type, cfg.data.seq,
            f"{cfg.data.start_frame}_{cfg.data.end_frame}")
        trainer.sd_guidance = build_guidance(
            cfg.sd, checkpoint_dir=sd_dir,
            lora_dir=lora_dir if os.path.isdir(lora_dir) else None,
            max_iters=cfg.opt.iterations, device=dev)
    trainer.init_from_normals()
    if extra.start_checkpoint is not None:
        trainer.load_checkpoint(extra.start_checkpoint)

    total = extra.iterations_override or cfg.opt.iterations
    start = int(trainer.state.step)
    logger = None
    if lead:
        logger = MetricsLogger(cfg.model.model_path)
        cfg.save(Path(cfg.model.model_path) / "cfg_args.json")
    barrier()
    t0 = time.time()
    for it in range(start + 1, total + 1):
        m = trainer.train_iteration(it)
        if it % 50 == 0 and lead:
            m.update(iter=it, elapsed_s=round(time.time() - t0, 1),
                     n_active=int(trainer.state.field.num_active()))
            logger.log(m, step=it)
        if it in extra.test_iterations:
            if lead:
                logger.log(trainer.training_report(
                    it, out_dir=Path(cfg.model.model_path) / "results"),
                    step=it)
            barrier()
        if it in extra.save_iterations:
            if lead:
                _save(trainer, it)
            barrier()
        if it in extra.checkpoint_iterations:
            if lead:
                trainer.save_checkpoint(it)
            barrier()
    if lead:
        _save(trainer, total)
        logger.close()
    barrier()
    return trainer


def _save(trainer: Trainer, it: int) -> None:
    """The Trainer's current fields into its scene, written as PLYs."""
    trainer.scene.gaussians = trainer.state.field
    trainer.scene.box_gaussians.update(trainer.box_fields)
    trainer.scene.save(it)


if __name__ == "__main__":
    main(sys.argv[1:])
