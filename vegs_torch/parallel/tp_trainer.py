"""The fully sharded trainer (port of vegs_tpu/parallel/tp_trainer.py): no
replicated per-Gaussian state.

The field, its Adam moments and its densify statistics live sharded on the
`shard` axis (each rank one row block); one camera is trained per step and
the render is the tile-sharded rasterizer (`tile_sharded.tile_render_local`:
an N/D front end, one all-to-all splat exchange, each rank blends its own
tile rows). The loss needs the whole image (SSIM's window crosses shard
rows), so the rank's rows are all-gathered and every rank computes the
same loss; the gather's backward sums the D copies of each row's
cotangent, so the step differentiates loss / D. Each Gaussian lives on one
rank: there is no gradient collective, and Adam and the statistics are
row-local.

  * `make_tp_train_step` -- the static field, one camera;
  * `make_dp_mesh_2d`, `make_dp_tp_train_step` -- a (data, shard) mesh:
    the exchange and the image gather on the shard axis, each data row its
    own camera, the gradient and statistics reductions on the data axis;
  * `tp_densify_and_prune` -- each rank recompacts its own rows, to the
    largest shard's need (equal shard sizes), and the active count is
    summed;
  * `make_tp_full_train_step` -- the full model: box fields sharded on
    their capacity axis, the box residuals replicated and their gradients
    summed over the axis; guidance and perceptual terms through the same
    tile-sharded render of an augmented view.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import densify, optim, train
from ..boxmodel import BoxDeltas, regularize_loss
from ..gaussians import DensifyStats, GaussianField, round_capacity
from ..ops import blend_ref
from ..ops.projection import CameraParams
from ..ops.rasterize import RasterizeConfig
from ..render import BoxInstance, field_arrays, frame_arrays
from .comm import all_gather, pmax, pmax_tree, psum, psum_mean, psum_tree
from .gauss_sharded import shard_rows
from .mesh import Mesh, make_grid_mesh
from .sharded_step import camera_at
from .tile_sharded import TILE_AXIS, make_tile_plan, tile_render_local

DATA = "data"


def _shard_axis(mesh: Mesh) -> str:
    return TILE_AXIS if TILE_AXIS in mesh.axis_names else mesh.axis_names[-1]


def shard_field(field: GaussianField, index: int, n: int) -> GaussianField:
    """Row block `index` of `n` of a field, as a new field."""
    return GaussianField(valid=shard_rows(field.valid, index, n).clone(), **{
        k: shard_rows(getattr(field, k).detach(), index, n).clone()
        for k in optim.PARAM_LEAVES})


def shard_train_state(mesh: Mesh, field: GaussianField, opt: dict,
                      stats: DensifyStats):
    """This rank's row block of (field, Adam state, stats) over the shard
    axis; the Adam count stays whole."""
    c = mesh.comm(_shard_axis(mesh))
    i, n = c.index, c.size
    return (shard_field(field, i, n),
            {**{m: {k: shard_rows(v, i, n).clone() for k, v in opt[m].items()}
                for m in ("mu", "nu")}, "count": opt["count"].clone()},
            DensifyStats(*[shard_rows(getattr(stats, k), i, n).clone()
                           for k in ("max_radii2d", "xyz_gradient_accum",
                                     "denom")]))


class KCapAdapter:
    """The Trainer's grow/decay capacity policy for sharded runs, where the
    caller rebuilds the step per k_cap: feed each step's num_dropped and
    num_needed to `update()`; a non-None return is the new global k_cap.
    Grow 2x on any drop (up to k_cap_max); halve after `decay_window`
    consecutive steps below 25% use (down to k_cap_min). num_needed is in
    global k_cap units already (the worst rank times D)."""

    def __init__(self, k_cap: int, k_cap_min: int = 1 << 15,
                 decay_window: int = 200, k_cap_max: int = 1 << 24):
        self.k_cap = int(k_cap)
        self.k_cap_min = int(k_cap_min)
        self.k_cap_max = int(k_cap_max)
        self.decay_window = int(decay_window)
        self._low_streak = 0

    def update(self, num_dropped: float, num_needed: float) -> Optional[int]:
        if num_dropped > 0 and self.k_cap < self.k_cap_max:
            self.k_cap = min(self.k_cap * 2, self.k_cap_max)
            self._low_streak = 0
            return self.k_cap
        if 0 < num_needed < 0.25 * self.k_cap:
            self._low_streak += 1
        else:
            self._low_streak = 0
        if (self._low_streak >= self.decay_window
                and self.k_cap // 2 >= self.k_cap_min):
            self.k_cap //= 2
            self._low_streak = 0
            return self.k_cap
        return None


def _zero_grads(*fields) -> None:
    for f in fields:
        for p in f.parameters():
            p.grad = None


class WholeImage(NamedTuple):
    """The gathered tile rows' maps that `train.image_loss` scores."""

    rgb: torch.Tensor        # [3, H, W] over the background
    cov_quat: torch.Tensor   # [4, H, W]
    cov_scale: torch.Tensor  # [3, H, W]


def _whole_image(out_loc, comm, H, W, bg) -> WholeImage:
    """The image of the gathered tile rows."""
    out = all_gather(out_loc, comm, dim=1)
    t_fin = out[blend_ref.N_ACCUM, :H, :W]
    return WholeImage(rgb=out[0:3, :H, :W] + t_fin[None] * bg[:, None, None],
                      cov_quat=out[4:8, :H, :W], cov_scale=out[8:11, :H, :W])


def _static_sharded_step(plan, shard, data, opt_cfg, raster_cfg,
                         spatial_scale, use_normal_loss, sh_total_degree):
    """The TP step's body; with a data axis, the DP x TP step's."""
    n_shard = shard.size

    def fn(field, opt_state, stats, step, cam, gt, normal, active_sh_degree,
           bg):
        H, W = cam.height, cam.width
        _zero_grads(field)
        m2d = torch.zeros((field.capacity, 2), dtype=torch.float32,
                          device=field.means.device, requires_grad=True)
        a = field_arrays(field, active_sh_degree)
        out_loc, proj, (dropped, needed, needed_ex) = tile_render_local(
            plan, cam, raster_cfg, sh_total_degree, shard, *a,
            means2d_offset=m2d)
        loss, ll1, _ = train.image_loss(
            _whole_image(out_loc, shard, H, W, bg), gt, normal,
            float(use_normal_loss), opt_cfg)
        # every shard takes the same loss: the gather's backward sums the
        # n_shard copies, so differentiate loss / n_shard (densify's
        # absolute thresholds must not inflate)
        (loss / n_shard).backward()
        grads = optim.leaf_grads(field)
        loss, ll1 = loss.detach(), ll1.detach()
        caps = {"num_dropped": dropped, "num_needed": needed,
                "num_needed_exch": needed_ex}
        g_m2d = m2d.grad if m2d.grad is not None else torch.zeros_like(m2d)
        norm_c, vis_c, rad_c = densify.stats_contribution(g_m2d, proj.radii,
                                                          H, W)
        if data is not None:  # camera-batch reduction of shard-local rows
            nd = data.size
            grads = {k: v / nd for k, v in psum_tree(grads, data).items()}
            red = psum_mean(torch.stack([loss, ll1]), data)
            loss, ll1 = red[0], red[1]
            norm_c, vis_c = psum(norm_c, data), psum(vis_c, data)
            rad_c = pmax(rad_c, data)
            caps = pmax_tree(caps, data)
        optim.adam_step(field, grads, opt_state,
                        optim.field_lrs(opt_cfg, spatial_scale, step))
        new_stats = densify.apply_stats(stats, norm_c, vis_c, rad_c)
        return (field, opt_state, new_stats, step + 1,
                {"loss": loss, "l1": ll1, **caps})

    return fn


def make_tp_train_step(mesh: Mesh, opt_cfg, raster_cfg: RasterizeConfig,
                       spatial_scale: float, cam: CameraParams,
                       use_normal_loss: bool = False,
                       sh_total_degree: int = 3,
                       k_exch: Optional[int] = None):
    """fn(field, opt, stats, step, cam, gt, normal, active_sh_degree, bg)
    -> (field, opt, stats, step + 1, metrics). field, opt and stats are
    this rank's row blocks (`shard_train_state`), updated in place; the
    camera, gt and normal are the same on every rank. `cam` at build time
    gives the resolution only. Metrics: loss, l1, num_dropped, num_needed,
    num_needed_exch."""
    shard = mesh.comm(_shard_axis(mesh))
    plan = make_tile_plan(shard.size, cam, raster_cfg, k_exch)
    return _static_sharded_step(plan, shard, None, opt_cfg, raster_cfg,
                                spatial_scale, use_normal_loss,
                                sh_total_degree)


def make_dp_mesh_2d(n_data: int, n_shard: int) -> Mesh:
    """The (data, shard) mesh: camera batch on the outer axis, the
    Gaussian/tile shard on the inner one (contiguous ranks)."""
    return make_grid_mesh((DATA, TILE_AXIS), (n_data, n_shard))


def make_dp_tp_train_step(mesh: Mesh, opt_cfg, raster_cfg: RasterizeConfig,
                          spatial_scale: float, cam: CameraParams,
                          use_normal_loss: bool = False,
                          sh_total_degree: int = 3,
                          k_exch: Optional[int] = None):
    """The 2-D step: fn(field, opt, stats, step, cam_batch, gt_batch,
    normal_batch, active_sh_degree, bg); the field sharded over the shard
    axis and alike across data rows; data row d trains row d of the batch
    (leaves [n_data, ...]). Gradients are averaged and the statistics
    reduced over the data axis."""
    shard, data = mesh.comm(TILE_AXIS), mesh.comm(DATA)
    plan = make_tile_plan(shard.size, cam, raster_cfg, k_exch)
    body = _static_sharded_step(plan, shard, data, opt_cfg, raster_cfg,
                                spatial_scale, use_normal_loss,
                                sh_total_degree)

    def fn(field, opt_state, stats, step, cam_batch, gt_batch, normal_batch,
           active_sh_degree, bg):
        d = data.index
        return body(field, opt_state, stats, step, camera_at(cam_batch, d),
                    gt_batch[d], normal_batch[d], active_sh_degree, bg)

    return fn


def tp_densify_and_prune(mesh: Mesh, field: GaussianField, opt: dict,
                         stats: DensifyStats,
                         generator: Optional[torch.Generator] = None, *,
                         grad_threshold: float, percent_dense: float,
                         extent: float, min_opacity: float = 0.005,
                         max_screen_size: int = 0,
                         capacity_headroom: float = 1.0, noise=None):
    """Shard-local densify and prune of this rank's (field, Adam, stats):
    the clone/split/prune decisions are row-local, so each rank recompacts
    its own rows (children stay on their parent's rank). Every rank's
    capacity is the largest rank's need, rounded up to a multiple of 512,
    so the shards stay equal. Returns (field, opt, stats, active count over
    the axis)."""
    comm = mesh.comm(_shard_axis(mesh))
    masks = densify.densify_masks(field, stats, grad_threshold, percent_dense,
                                  extent, min_opacity, max_screen_size)
    clone, split, prune = masks
    keep = field.valid & ~prune & ~split
    n_out = (keep.sum() + clone.sum() + 2 * split.sum()).to(torch.int64)
    worst = int(pmax(n_out, comm))
    cap_loc = round_capacity(int(worst * capacity_headroom) + 1,
                             multiple=512)
    f, o, s, n = densify._recompact(field, opt, masks, cap_loc, generator,
                                    noise)
    total = psum(torch.tensor(n, dtype=torch.int64,
                              device=field.means.device), comm)
    return f, o, s, int(total)


def make_tp_full_train_step(mesh: Mesh, opt_cfg, raster_cfg: RasterizeConfig,
                            spatial_scale: float, cam: CameraParams,
                            use_normal_loss: bool, n_box_slots: int,
                            box_lr_mult: float, boxmodel_lr: float,
                            boxmodel_lambda_reg: float,
                            sh_total_degree: int = 3,
                            k_exch: Optional[int] = None,
                            guidance=None,
                            aug_cam: Optional[CameraParams] = None,
                            perceptual_lam: float = 0.0,
                            k_exch_aug: Optional[int] = None):
    """The full model (static field, box fields, box residuals) with every
    per-Gaussian tensor sharded: the static field on its capacity axis and
    each box slot's field on its own.

    fn(field, opt, stats, step, box_fields, box_opts, box_stats, deltas,
       delta_opt, box2worlds, active, cam, gt, normal, normal_valid,
       active_sh_degree, bg, extras=None)
      -> (field, opt, stats, step + 1, box_fields, box_opts, box_stats,
          deltas, delta_opt, metrics)

    box_fields, box_opts and box_stats are lists of n_box_slots (this
    rank's row block of each slot); deltas a BoxDeltas with leaves [S, .]
    and delta_opt its Adam state (`optim.adam_init`), the same on every
    rank; box2worlds [S, 4, 4] and active [S] bool. The slots are composed
    as `render.frame_arrays` composes a frame's boxes, an inactive slot's
    rows masked out. Fields, residuals and their Adam states are updated in
    place. The residuals' gradients are summed over the axis (each rank
    holds its own rows' share, and 1/D of the regularizer) and NaN-guarded,
    so their Adam step stays the same on every rank; an inactive slot's
    field keeps its values and moments, and its residual its values, while
    the residual's moments and every Adam count advance, as in the JAX
    step. Box learning rates take no spatial scale.

    With `guidance` (an `SDGuidance`; `aug_cam` the augmented view's shape
    template) `extras` carries "guided" (a `train.GuidedView` of the
    augmented camera, crop start and draws): the static field alone is
    rendered there through the same tile-sharded path, and the crop's
    guidance loss at `step` joins the loss. With `perceptual_lam`, extras
    carries "vgg" (VGG16's features) and lam times the perceptual loss of
    the composite render joins it."""
    shard = mesh.comm(_shard_axis(mesh))
    ndev = shard.size
    plan = make_tile_plan(ndev, cam, raster_cfg, k_exch)
    plan_aug = (make_tile_plan(ndev, aug_cam, raster_cfg, k_exch_aug)
                if guidance is not None else None)

    def fn(field, opt_state, stats, step, box_fields, box_opts, box_stats,
           deltas, delta_opt, box2worlds, active, cam, gt, normal,
           normal_valid, active_sh_degree, bg, extras=None):
        H, W = cam.height, cam.width
        _zero_grads(field, *box_fields)
        dl = BoxDeltas(**{k: v.detach().clone().requires_grad_(True)
                          for k, v in deltas.as_dict().items()})
        arrays = frame_arrays(field, [
            BoxInstance(bf, box2worlds[i], BoxDeltas(
                **{k: v[i] for k, v in dl.as_dict().items()}))
            for i, bf in enumerate(box_fields)], active_sh_degree)
        sizes = [field.capacity] + [bf.capacity for bf in box_fields]
        # an inactive slot's rows render nothing
        arrays = arrays._replace(valid=torch.cat([
            v if i == 0 else v & active[i - 1]
            for i, v in enumerate(arrays.valid.split(sizes))]))
        m2d = torch.zeros((sum(sizes), 2), dtype=torch.float32,
                          device=field.means.device, requires_grad=True)
        out_loc, proj, (dropped, needed, needed_ex) = tile_render_local(
            plan, cam, raster_cfg, sh_total_degree, shard, *arrays,
            means2d_offset=m2d)
        image = _whole_image(out_loc, shard, H, W, bg)
        loss, ll1, nloss = train.image_loss(
            image, gt, normal, normal_valid if use_normal_loss else 0.0,
            opt_cfg)
        reg = (regularize_loss(dl) * active.to(torch.float32)).sum()
        loss = loss + boxmodel_lambda_reg * reg
        metrics = {}
        if perceptual_lam:
            from ..losses.perceptual import vgg_perceptual_loss

            p_loss = vgg_perceptual_loss(extras["vgg"], image.rgb, gt)
            loss = loss + perceptual_lam * p_loss
            metrics["perceptual_loss"] = p_loss.detach()
        if guidance is not None:
            # the augmented view: the static field only, as the reference
            # renders it (train.py:177), through the same sharded path
            g = extras["guided"]
            a = field_arrays(field, active_sh_degree)
            aug_loc, _, _ = tile_render_local(
                plan_aug, g.cam, raster_cfg, sh_total_degree, shard, *a)
            rgb_a = _whole_image(aug_loc, shard, g.cam.height, g.cam.width,
                                 bg).rgb
            h, w = rgb_a.shape[1:]
            s0 = min(max(int(g.crop_start), 0), w - h)
            g_loss = guidance(rgb_a[:, :, s0:s0 + h], step,
                              generator=g.generator, draws=g.draws)
            loss = loss + g_loss
            metrics["guidance_loss"] = g_loss.detach()
        (loss / ndev).backward()

        g_delta = psum_tree({k: torch.zeros_like(v) if v.grad is None
                             else v.grad for k, v in dl.as_dict().items()},
                           shard)
        g_delta = {k: torch.nan_to_num(v, nan=0.0) for k, v in g_delta.items()}
        g_m2d = m2d.grad if m2d.grad is not None else torch.zeros_like(m2d)
        norm, vis, rad = densify.stats_contribution(g_m2d, proj.radii, H, W)
        norm, vis, rad = (x.split(sizes) for x in (norm, vis, rad))

        optim.adam_step(field, optim.leaf_grads(field), opt_state,
                        optim.field_lrs(opt_cfg, spatial_scale, step))
        new_stats = densify.apply_stats(stats, norm[0], vis[0], rad[0])
        box_lrs = optim.field_lrs(opt_cfg, 1.0, step, xyz_lr_mult=box_lr_mult)
        act = [bool(a) for a in active.tolist()]
        new_bstats = []
        for i, (bf, bo, bs) in enumerate(zip(box_fields, box_opts,
                                             box_stats)):
            if act[i]:
                optim.adam_step(bf, optim.leaf_grads(bf), bo, box_lrs)
            else:
                bo["count"] = bo["count"] + 1
            new_bstats.append(densify.apply_stats(bs, norm[i + 1],
                                                  vis[i + 1], rad[i + 1]))
        optim.adam_step(deltas, g_delta, delta_opt, boxmodel_lr, eps=1e-8)
        keep = active.reshape(-1, 1)
        for k, v in dl.as_dict().items():  # an inactive slot's residual stays
            getattr(deltas, k).copy_(torch.where(keep, getattr(deltas, k),
                                                 v.detach()))
        metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                   "normal_loss": nloss.detach(), "num_dropped": dropped,
                   "num_needed": needed, "num_needed_exch": needed_ex,
                   **metrics}
        return (field, opt_state, new_stats, step + 1, box_fields, box_opts,
                new_bstats, deltas, delta_opt, metrics)

    return fn
