"""Densification and pruning as fixed-capacity recompaction (port of
vegs_tpu/densify.py).

Boolean masks decide clone / split / prune; the kept rows, the clones and
two children per split parent are then written into fresh arrays of a
bucketed capacity, parameters and Adam moments row for row:
  * accumulate ||grad means2D|| (NDC-scaled) over visible Gaussians and the
    max screen radius;
  * clone: avg grad >= tau and max(scale) <= percent_dense * extent;
  * split: avg grad >= tau and max(scale) > percent_dense * extent -> 2
    children sampled from the Gaussian, scales / 1.6, parent removed;
  * prune: opacity < 0.005, or (with max_screen_size) screen radius >
    max_screen_size or world scale > 0.1 * extent;
  * new rows start with zero Adam moments; kept rows keep theirs;
  * opacity reset clamps opacity to <= 0.01 and zeroes its Adam moments.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import geometry
from .gaussians import DensifyStats, GaussianField, round_capacity
from .optim import PARAM_LEAVES


def stats_contribution(means2d_grad: torch.Tensor, radii: torch.Tensor,
                       image_height: int, image_width: int):
    """One view's contributions (norm, vis, radii_f): the gradient of the
    pixel-space means2d tap scaled to NDC (W/2, H/2), its norm where the
    Gaussian is visible, the visibility count and the radius."""
    vis = radii > 0
    scale = torch.tensor([image_width * 0.5, image_height * 0.5],
                         dtype=means2d_grad.dtype, device=means2d_grad.device)
    norm = torch.linalg.norm(means2d_grad * scale, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=norm.device)
    return (torch.where(vis, norm, zero), vis.to(torch.float32),
            torch.where(vis, radii.to(torch.float32), zero))


def apply_stats(stats: DensifyStats, norm_sum, vis_sum, radii_max) -> DensifyStats:
    """Fold one view's contributions into the running stats."""
    return DensifyStats(
        max_radii2d=torch.maximum(stats.max_radii2d, radii_max),
        xyz_gradient_accum=stats.xyz_gradient_accum + norm_sum,
        denom=stats.denom + vis_sum,
    )


def update_stats(stats: DensifyStats, means2d_grad, radii, image_height: int,
                 image_width: int) -> DensifyStats:
    """Single-view convenience over stats_contribution + apply_stats."""
    return apply_stats(stats, *stats_contribution(
        means2d_grad, radii, image_height, image_width))


@torch.no_grad()
def densify_masks(field: GaussianField, stats: DensifyStats,
                  grad_threshold: float, percent_dense: float, extent: float,
                  min_opacity: float = 0.005, max_screen_size: int = 0):
    """Boolean decision masks (clone, split, prune) over the capacity axis."""
    avg_grad = stats.xyz_gradient_accum / torch.clamp(stats.denom, min=1.0)
    high_grad = (avg_grad >= grad_threshold) & field.valid
    max_scale = torch.max(field.scales(), dim=1).values
    small = max_scale <= percent_dense * extent
    clone = high_grad & small
    split = high_grad & ~small
    opacity = torch.sigmoid(field.opacity_logit[:, 0])
    prune = (opacity < min_opacity) & field.valid
    if max_screen_size > 0:
        prune = prune | (field.valid & ((stats.max_radii2d > max_screen_size)
                                        | (max_scale > 0.1 * extent)))
    return clone, split, prune


@torch.no_grad()
def _recompact(field: GaussianField, opt: dict, masks, out_capacity: int,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               split_scale_div: float = 1.6, n_split_children: int = 2):
    """Write [kept | clones | split children x2] into arrays of
    `out_capacity` rows. The children's offsets are `noise` ([2, C, 3]
    standard normal draws) when given, else drawn from `generator`."""
    clone, split, prune = masks
    cin = field.capacity
    dev = field.means.device
    keep = field.valid & ~prune & ~split

    def cum(m):
        return torch.cumsum(m.to(torch.int64), dim=0) - 1

    keep_pos = cum(keep)
    n_keep = int(keep.sum())
    clone_pos = n_keep + cum(clone)
    n_clone = int(clone.sum())
    split_base = n_keep + n_clone + n_split_children * cum(split)
    n_split = int(split.sum())

    scales = field.scales()
    if noise is None:
        noise = torch.randn((n_split_children, cin, 3), generator=generator,
                            device=generator.device if generator is not None
                            else dev).to(dev)
    noise = noise.to(dev) * scales[None, :, :]
    rots = geometry.quat_to_rotmat(field.quats)
    child_means = field.means[None] + torch.einsum("nij,knj->kni", rots, noise)
    child_log_scales = field.log_scales - math.log(split_scale_div)

    def place(dst, src, pos, mask):
        dst[pos[mask]] = src[mask]

    out = {}
    for name in PARAM_LEAVES:
        src = getattr(field, name)
        dst = torch.zeros((out_capacity,) + src.shape[1:], dtype=src.dtype,
                          device=dev)
        place(dst, src, keep_pos, keep)
        place(dst, src, clone_pos, clone)
        for k in range(n_split_children):
            child = (child_means[k] if name == "means" else
                     child_log_scales if name == "log_scales" else src)
            place(dst, child, split_base + k, split)
        out[name] = dst
    n_total = n_keep + n_clone + n_split_children * n_split
    valid = torch.arange(out_capacity, device=dev) < min(n_total, out_capacity)
    new_field = GaussianField(valid=valid, **out)

    def carry(moments: dict) -> dict:
        res = {}
        for name in PARAM_LEAVES:
            src = moments[name]
            dst = torch.zeros((out_capacity,) + src.shape[1:],
                              dtype=src.dtype, device=dev)
            place(dst, src, keep_pos, keep)
            res[name] = dst
        return res

    new_opt = {"mu": carry(opt["mu"]), "nu": carry(opt["nu"]),
               "count": opt["count"]}
    return new_field, new_opt, DensifyStats.zeros(out_capacity, dev), n_total


def densify_and_prune(field: GaussianField, opt: dict, stats: DensifyStats,
                      generator: Optional[torch.Generator] = None, *,
                      grad_threshold: float, percent_dense: float,
                      extent: float, min_opacity: float = 0.005,
                      max_screen_size: int = 0,
                      capacity_headroom: float = 1.0,
                      noise: Optional[torch.Tensor] = None):
    """Decide masks, pick the output capacity bucket, recompact. Returns
    (field, opt_state, stats, n_active). Split children draw from
    `generator`, or take `noise` ([2, capacity, 3]) when given."""
    masks = densify_masks(field, stats, grad_threshold, percent_dense, extent,
                          min_opacity, max_screen_size)
    clone, split, prune = masks
    keep = field.valid & ~prune & ~split
    n_out = int(keep.sum()) + int(clone.sum()) + 2 * int(split.sum())
    out_capacity = round_capacity(int(n_out * capacity_headroom) + 1)
    return _recompact(field, opt, masks, out_capacity, generator, noise)


def prune_only(field: GaussianField, opt: dict, stats: DensifyStats, *,
               min_opacity: float = 0.005, max_screen_size: int = 0,
               extent: float = 0.0):
    """Pruning without densification (the same recompaction)."""
    false = torch.zeros((field.capacity,), dtype=torch.bool,
                        device=field.means.device)
    _, _, prune = densify_masks(field, stats, math.inf, 1.0, max(extent, 1e-9),
                                min_opacity, max_screen_size)
    keep_n = int((field.valid & ~prune).sum())
    return _recompact(field, opt, (false, false, prune),
                      round_capacity(keep_n + 1),
                      noise=torch.zeros((2, field.capacity, 3)))


@torch.no_grad()
def reset_opacity(field: GaussianField, opt: dict, ceiling: float = 0.01):
    """Clamp opacities to <= ceiling and zero the opacity Adam moments.
    Returns a new field and state (copies; the inputs are left as they
    were)."""
    logit = torch.clamp(field.opacity_logit,
                        max=float(math.log(ceiling / (1.0 - ceiling))))
    arrays = {k: getattr(field, k).detach().clone() for k in PARAM_LEAVES}
    arrays["opacity_logit"] = logit
    new_field = GaussianField(valid=field.valid.clone(), **arrays)
    new_opt = {"mu": dict(opt["mu"]), "nu": dict(opt["nu"]),
               "count": opt["count"]}
    for m in ("mu", "nu"):
        new_opt[m]["opacity_logit"] = torch.zeros_like(opt[m]["opacity_logit"])
    return new_field, new_opt
