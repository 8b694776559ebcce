"""Renderer API over the rasterizer (port of vegs_tpu/render.py, static
field only; render_dyn/render_all with dynamic boxes wait). `_run` is the
training step's entry: it renders prepared field arrays with a means2d
gradient tap."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import geometry, sh as sh_lib
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
        override_color = torch.clamp(
            sh_lib.eval_sh(active_sh_degree,
                           arrays.shs[:, :k, :].transpose(1, 2), dirs) + 0.5,
            min=0.0)
    return rasterize(
        arrays.means, arrays.quats, arrays.scales, arrays.opacities,
        arrays.shs, cam,
        colors_precomp=override_color, cov6_precomp=cov6_precomp,
        sh_degree=sh_degree, bg=bg, scale_modifier=scale_modifier,
        valid=arrays.valid, means2d_offset=means2d_offset, config=config)
