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
in (`boxmodel.adjust_box2world`). The parts are concatenated [static | box_0
| box_1 | ...] in front of the same `rasterize`, so the kernels (K1-K4) see
one field; `_bounds` gives each part's rows, so the means2d tap's gradient
splits per part for the densify statistics. `_run` is the training step's
entry: it renders prepared field arrays with a means2d gradient tap."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import boxmodel, geometry, sh as sh_lib
from .gaussians import GaussianField, sh_band_mask
from .ops.projection import CameraParams
from .ops.rasterize import RasterOut, RasterizeConfig, rasterize


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


def field_arrays(field: GaussianField, active_sh_degree: int = 3) -> FieldArrays:
    mask = sh_band_mask(active_sh_degree, device=field.means.device)[None, :, None]
    return FieldArrays(
        means=field.means,
        quats=field.rotations(),
        scales=field.scales(),
        opacities=field.opacities()[:, 0],
        shs=field.features() * mask,
        valid=field.valid,
    )


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
    [4, 4] to a canonical-space field's arrays."""
    means_h = torch.cat([arrays.means,
                         torch.ones((arrays.means.shape[0], 1),
                                    dtype=arrays.means.dtype,
                                    device=arrays.means.device)], dim=1)
    means_w = (means_h @ box2world.T)[:, :3]
    R_box, S_box, _ = geometry.decompose_T_to_RS(box2world)
    composed = R_box[None] @ geometry.quat_to_rotmat(arrays.quats)
    return arrays._replace(means=means_w,
                           quats=geometry.rotmat_to_quat(composed),
                           scales=arrays.scales * S_box[None, :])


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


def _box_arrays(box: BoxInstance, active_sh_degree) -> FieldArrays:
    b2w = box.box2world
    if box.deltas is not None:
        b2w = boxmodel.adjust_box2world(b2w, box.deltas)
    return transform_field_arrays(field_arrays(box.field, active_sh_degree), b2w)


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
    arrays = _concat_arrays([_box_arrays(b, active_sh_degree) for b in boxes])
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
    parts = [field_arrays(static_field, active_sh_degree)]
    parts += [_box_arrays(b, active_sh_degree) for b in boxes]
    out = _run(camera, _concat_arrays(parts), bg=bg,
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
