"""The static data-parallel step (port of vegs_tpu/parallel/sharded_step.py):
a batch of cameras over the data axis, each rank one camera against the
replicated field; the per-Gaussian gradients are averaged with one
all-reduce, and the replicated Adam update then runs the same on every
rank. The densify statistics add each view's contribution (norms and
visibility summed, radii maxed over the ranks), not the summed gradient's,
so opposing views do not cancel (vegs_tpu/parallel/sharded_step.py:97-106).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import densify, optim
from ..losses import l1_loss, loss_normal_guidance, ssim
from ..ops.projection import CameraParams
from ..ops.rasterize import RasterizeConfig
from ..render import _run, field_arrays
from .comm import pmax, psum, psum_mean, psum_tree
from .mesh import DATA_AXIS, Mesh


def stack_camera_batch(cams: list, device=None) -> CameraParams:
    """Cameras (their CameraParams on `device`, default the card) or
    CameraParams -> one CameraParams with leaves [D, ...]."""
    params = [c if isinstance(c, CameraParams) else c.device_params(device)
              for c in cams]
    h, w = params[0].height, params[0].width
    if any(p.height != h or p.width != w for p in params):
        raise ValueError("a camera batch shares one resolution")
    return CameraParams(**{
        f.name: torch.stack([getattr(p, f.name) for p in params])
        for f in dataclasses.fields(CameraParams)
        if f.name not in ("height", "width")}, height=h, width=w)


def camera_at(batch: CameraParams, i: int) -> CameraParams:
    """Row i of a stacked camera batch."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[i]
        for f in dataclasses.fields(CameraParams)
        if f.name not in ("height", "width")})


def make_dp_train_step(mesh: Mesh, opt_cfg, raster_cfg: RasterizeConfig,
                       spatial_scale: float, height: int, width: int,
                       use_normal_loss: bool = False,
                       sh_total_degree: int = 3):
    """fn(field, opt, stats, step, cam_batch, gt_batch, normal_batch,
    active_sh_degree, bg) -> (field, opt, stats, step + 1, metrics).

    The state is replicated (the same on every rank); cam_batch (leaves
    [D, ...]), gt_batch and normal_batch ([D, 3, H, W]) hold every rank's
    row, and rank r takes row r, as device r of the JAX mesh sees its
    shard. The field's parameters and Adam moments are updated in place."""
    comm = mesh.comm(DATA_AXIS if DATA_AXIS in mesh.axis_names else None)
    lam_dssim = opt_cfg.lambda_dssim

    def fn(field, opt_state, stats, step, cam_batch, gt_batch, normal_batch,
           active_sh_degree, bg):
        me = comm.index
        cam = camera_at(cam_batch, me)
        gt, normal = gt_batch[me], normal_batch[me]
        for p in field.parameters():
            p.grad = None
        m2d = torch.zeros((field.capacity, 2), dtype=torch.float32,
                          device=field.means.device, requires_grad=True)
        out = _run(cam, field_arrays(field, active_sh_degree), bg=bg,
                   scale_modifier=1.0, override_color=None,
                   sh_degree=sh_total_degree, config=raster_cfg,
                   means2d_offset=m2d)
        ll1 = l1_loss(out.rgb, gt)
        loss = (1 - lam_dssim) * ll1 + lam_dssim * (1.0 - ssim(out.rgb, gt))
        if use_normal_loss:
            loss = loss + opt_cfg.lambda_dnormal * loss_normal_guidance(
                out.cov_quat, out.cov_scale, normal)
        loss.backward()

        # per-Gaussian gradient all-reduce over the camera batch
        nd = comm.size
        grads = {k: v / nd for k, v in
                 psum_tree(optim.leaf_grads(field), comm).items()}
        red = psum_mean(torch.stack([loss.detach(), ll1.detach()]), comm)

        optim.adam_step(field, grads, opt_state,
                        optim.field_lrs(opt_cfg, spatial_scale, step))
        g_m2d = (m2d.grad if m2d.grad is not None else torch.zeros_like(m2d))
        norm_c, vis_c, rad_c = densify.stats_contribution(g_m2d, out.radii,
                                                          height, width)
        new_stats = densify.apply_stats(
            stats, psum(norm_c, comm), psum(vis_c, comm), pmax(rad_c, comm))
        return field, opt_state, new_stats, step + 1, {"loss": red[0],
                                                       "l1": red[1]}

    return fn
