"""Renderer API over the rasterizer (port of vegs_tpu/render.py).

  render()      -- the static field;
  render_dyn()  -- dynamic boxes only (default scale modifier 2.0, as the
                   reference's render_dyn);
  render_all()  -- the static field and the boxes composited in ONE
                   rasterizer call.

A box field lives in its canonical unit box; `transform_field_arrays` maps
it to the world with the frame's box-to-world transform (means transformed,
rotation composed R_box @ R_gauss through quaternions, scales multiplied by
the box's axis scales), after the learnable `BoxDeltas` residual is folded
in (`boxmodel.adjust_box2world`). `compose_boxes` does that for every box
of a call in one batched pass, under the span `boxes.compose`: the host's
dispatch, not the rows, sets its cost. `frame_arrays` concatenates the
parts [static | box_0 | box_1 | ...] in front of the same `rasterize`, so
the kernels (K1-K4) see one field; it is the one way a frame's arrays are
built, for `render_all`, the training steps and the tools. `_bounds` gives
each part's rows, so the means2d tap's gradient splits per part for the
densify statistics. `_run` renders prepared field arrays with a means2d
gradient tap."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import boxmodel, geometry, sh as sh_lib
from .gaussians import GaussianField, sh_band_mask
from .ops.projection import CameraParams
from .ops.rasterize import RasterOut, RasterizeConfig, rasterize
from .utils import trace


class FieldArrays(NamedTuple):
    """Activated per-Gaussian tensors ready for the rasterizer."""

    means: torch.Tensor
    quats: torch.Tensor
    scales: torch.Tensor
    opacities: torch.Tensor
    shs: torch.Tensor
    valid: torch.Tensor


def _as_cam_params(camera, device) -> CameraParams:
    if isinstance(camera, CameraParams):
        return camera
    return camera.device_params(device)


# a field's raw (pre-activation) tensors, in GaussianField's order
_RAW = ("means", "quats", "log_scales", "sh_dc", "sh_rest", "opacity_logit",
       "valid")


def _activate(means, quats, log_scales, sh_dc, sh_rest, opacity_logit,
              valid, active_sh_degree) -> FieldArrays:
    """The rasterizer's arrays from a field's raw rows, or from several
    fields' rows concatenated: dead slots get exactly 0 opacity, SH
    coefficients above the active degree 0."""
    mask = sh_band_mask(active_sh_degree, device=means.device)[None, :, None]
    quats = geometry.quat_normalize(quats)
    scales = torch.exp(log_scales)
    op = torch.sigmoid(opacity_logit)
    opacities = torch.where(valid[:, None], op, torch.zeros_like(op))[:, 0]
    return FieldArrays(means=means, quats=quats, scales=scales,
                       opacities=opacities,
                       shs=torch.cat([sh_dc, sh_rest], dim=1) * mask,
                       valid=valid)


def field_arrays(field: GaussianField, active_sh_degree: int = 3) -> FieldArrays:
    return _activate(*(getattr(field, k) for k in _RAW), active_sh_degree)


def _run(camera, arrays: FieldArrays, *, bg, scale_modifier, override_color,
         sh_degree, config, means2d_offset) -> RasterOut:
    cam = _as_cam_params(camera, arrays.means.device)
    return rasterize(
        arrays.means, arrays.quats, arrays.scales, arrays.opacities,
        arrays.shs, cam, colors_precomp=override_color, sh_degree=sh_degree,
        bg=bg, scale_modifier=scale_modifier, valid=arrays.valid,
        means2d_offset=means2d_offset, config=config)


def render(
    camera,
    field: GaussianField,
    *,
    bg: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    active_sh_degree: int = 3,
    sh_degree: int = 3,
    config: RasterizeConfig = RasterizeConfig(),
    means2d_offset: Optional[torch.Tensor] = None,
    convert_SHs_python: bool = False,
    compute_cov3D_python: bool = False,
) -> RasterOut:
    """Render the static field on the field's device. The pipe flags are
    the reference's: evaluate SH outside the rasterizer / precompute the
    3D covariance."""
    with trace.span("render.arrays"):
        arrays = field_arrays(field, active_sh_degree)
    cam = _as_cam_params(camera, field.means.device)
    cov6_precomp = None
    if compute_cov3D_python:
        cov6_precomp = geometry.strip_symmetric(
            geometry.covariance_from_scaling_rotation(
                arrays.scales, arrays.quats, scale_modifier))
    if convert_SHs_python and override_color is None:
        dirs = arrays.means - cam.campos[None, :]
        sq = torch.sum(dirs * dirs, dim=1, keepdim=True)
        dirs = dirs / torch.sqrt(torch.clamp(sq, min=1e-24))
        k = sh_lib.num_sh_coeffs(active_sh_degree)
        override_color = torch.maximum(  # as jnp.maximum at a tie
            sh_lib.eval_sh(active_sh_degree,
                           arrays.shs[:, :k, :].transpose(1, 2), dirs) + 0.5,
            arrays.means.new_zeros(()))
    return rasterize(
        arrays.means, arrays.quats, arrays.scales, arrays.opacities,
        arrays.shs, cam,
        colors_precomp=override_color, cov6_precomp=cov6_precomp,
        sh_degree=sh_degree, bg=bg, scale_modifier=scale_modifier,
        valid=arrays.valid, means2d_offset=means2d_offset, config=config)


def transform_field_arrays(arrays: FieldArrays,
                           box2world: torch.Tensor) -> FieldArrays:
    """Apply a box-to-world (rotation * scale + translation) transform
    [4, 4] to a canonical-space field's arrays (rows [C, ...]); or, with
    the rows grouped [G, C, ...], the transforms [G, 4, 4], one a group.
    The means are moved elementwise, a fused multiply-add a column: a row
    gets the same bits whether its transform is its group's or its own,
    where a matrix product would take a 1x4-by-4x4 product a row."""
    means, cols = arrays.means, box2world[..., None, :3, :]
    means_w = means[..., :1] * cols[..., 0]
    for k in (1, 2):
        means_w = torch.addcmul(means_w, means[..., k:k + 1], cols[..., k])
    means_w = means_w + cols[..., 3]
    R_box, S_box, _ = geometry.decompose_T_to_RS(box2world)
    composed = R_box[..., None, :, :] @ geometry.quat_to_rotmat(arrays.quats)
    return arrays._replace(means=means_w,
                           quats=geometry.rotmat_to_quat(composed),
                           scales=arrays.scales * S_box[..., None, :])


def _concat_arrays(parts: Sequence[FieldArrays]) -> FieldArrays:
    """The parts' rows in order; a single part is returned as it is (no
    copy on the static path)."""
    if len(parts) == 1:
        return parts[0]
    return FieldArrays(*[torch.cat(x, dim=0) for x in zip(*parts)])


class BoxInstance(NamedTuple):
    """One dynamic object in the current frame."""

    field: GaussianField
    box2world: torch.Tensor  # [4, 4] annotation transform
    deltas: Optional[boxmodel.BoxDeltas] = None  # learnable residual


def _box2world(boxes: Sequence[BoxInstance]) -> torch.Tensor:
    """[B, 4, 4]: the boxes' transforms with their residuals folded in, in
    one batched `adjust_box2world`. A box without a residual takes the
    identity, which leaves its matrix as it is to the bit."""
    b2w = torch.stack([b.box2world for b in boxes])
    if all(b.deltas is None for b in boxes):
        return b2w
    ds = [boxmodel.BoxDeltas.identity(b2w.device) if b.deltas is None
          else b.deltas for b in boxes]
    return boxmodel.adjust_box2world(b2w, boxmodel.BoxDeltas(**{
        k: torch.stack([getattr(d, k) for d in ds])
        for k in boxmodel.BoxDeltas.LEAVES}))


def compose_boxes(boxes: Sequence[BoxInstance],
                  active_sh_degree) -> FieldArrays:
    """The boxes' arrays in the world, rows [box_0 | box_1 | ...], in one
    batched pass under the span `boxes.compose`: the boxes' raw rows
    activated at once under one SH mask, then each row moved by its box's
    transform, expanded to the box's rows. The boxes are counted in
    `boxes.instances`. Callers call it only where there are boxes."""
    with trace.span("boxes.compose"):
        trace.count("boxes.instances", len(boxes))
        b2w = torch.cat([m.expand(b.field.capacity, 4, 4)
                         for m, b in zip(_box2world(boxes), boxes)])
        arrays = _activate(*(torch.cat([getattr(b.field, k) for b in boxes])
                             for k in _RAW), active_sh_degree)
        world = transform_field_arrays(
            FieldArrays(*(x[:, None] for x in arrays)), b2w)
        return FieldArrays(*(x[:, 0] for x in world))


def frame_arrays(static_field: GaussianField, boxes: Sequence[BoxInstance],
                 active_sh_degree) -> FieldArrays:
    """A frame's arrays under the span `render.arrays`: the static field's
    rows, then every box's in the world (`compose_boxes`), concatenated
    [static | box_0 | box_1 | ...]; without boxes, the static field's
    arrays themselves."""
    with trace.span("render.arrays"):
        parts = [field_arrays(static_field, active_sh_degree)]
        if boxes:
            parts.append(compose_boxes(boxes, active_sh_degree))
        return _concat_arrays(parts)


def render_dyn(
    camera,
    boxes: Sequence[BoxInstance],
    *,
    bg: Optional[torch.Tensor] = None,
    scale_modifier: float = 2.0,
    active_sh_degree: int = 3,
    sh_degree: int = 3,
    config: RasterizeConfig = RasterizeConfig(),
    means2d_offset: Optional[torch.Tensor] = None,
):
    """The boxes only (default scale modifier 2.0). Returns (RasterOut,
    row boundaries [len(boxes) + 1] over the concatenated Gaussians)."""
    with trace.span("render.arrays"):
        arrays = compose_boxes(boxes, active_sh_degree)
    out = _run(camera, arrays, bg=bg, scale_modifier=scale_modifier,
               override_color=None, sh_degree=sh_degree, config=config,
               means2d_offset=means2d_offset)
    return out, _bounds([b.field.capacity for b in boxes])


def render_all(
    camera,
    static_field: GaussianField,
    boxes: Sequence[BoxInstance],
    *,
    bg: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    active_sh_degree: int = 3,
    sh_degree: int = 3,
    config: RasterizeConfig = RasterizeConfig(),
    means2d_offset: Optional[torch.Tensor] = None,
):
    """The static field and the boxes composited in one rasterizer call.
    Returns (RasterOut, row boundaries [len(boxes) + 2] over the
    concatenated Gaussians: [static | box_0 | box_1 | ...])."""
    arrays = frame_arrays(static_field, boxes, active_sh_degree)
    out = _run(camera, arrays, bg=bg,
               scale_modifier=scale_modifier, override_color=None,
               sh_degree=sh_degree, config=config,
               means2d_offset=means2d_offset)
    return out, _bounds([static_field.capacity]
                        + [b.field.capacity for b in boxes])


def _bounds(sizes: Sequence[int]) -> list[int]:
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return out
