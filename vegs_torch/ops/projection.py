"""Gaussian preprocessing: cull -> project -> EWA conic -> SH color
(port of vegs_tpu/ops/projection.py).

Semantics (the JAX package's spec):
  * view-space position p = W_view @ [x,1]; cull when p.z <= znear (0.2).
  * 2D mean in PIXEL coordinates: ndc2pix(v, S) = ((v + 1) * S - 1) / 2.
  * 2D covariance: J = perspective Jacobian at the frustum-clamped view point
    (clamp x/z, y/z to 1.3*tan_fov); cov2d = T Sigma T^T with T = J @ R_view,
    plus a 0.3 px low-pass on the diagonal.
  * conic = cov2d^-1 (packed [a, b, c]); radius = ceil(bound * sigma_max).
  * color = SH(view_dir) + 0.5 clamped to >= 0.
The maths is written out as the same scalar expressions as the JAX version
so that float rounding stays close to it. Plain PyTorch, differentiable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import sh as sh_lib

ZNEAR = 0.2
LOWPASS = 0.3


@dataclasses.dataclass
class CameraParams:
    """Device-side camera. Matrices are stored TRANSPOSED (row-vector
    convention): p_view = [x, 1] @ viewmatrix. tan_fov* are 0-d tensors;
    height/width are static ints."""

    viewmatrix: torch.Tensor   # [4, 4] world->view (transposed storage)
    projmatrix: torch.Tensor   # [4, 4] full (view @ proj) transposed
    campos: torch.Tensor       # [3]
    tan_fovx: torch.Tensor     # 0-d
    tan_fovy: torch.Tensor     # 0-d
    height: int = 0
    width: int = 0


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities feeding binning + blending."""

    means2d: torch.Tensor   # [N, 2] pixel coords
    depths: torch.Tensor    # [N] view-space z
    conics: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor     # [N] int32 screen radius in px (0 = culled)
    rgb: torch.Tensor       # [N, 3]
    opacities: torch.Tensor  # [N]
    visible: torch.Tensor   # [N] bool
    radii_xy: torch.Tensor  # [N, 2] int32 per-axis AABB half-extents


def project(
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: CameraParams,
    sh_degree: int = 3,
    valid: torch.Tensor | None = None,
    means2d_offset: torch.Tensor | None = None,
    clamp_radius: int = 0,
) -> Projected:
    """Project N Gaussians to screen space.

    means3d [N, 3], cov6 [N, 6] packed world covariance, opacities [N] or
    [N, 1], shs [N, K, 3] (K >= (sh_degree+1)^2). `means2d_offset` is an
    optional [N, 2] gradient tap; `clamp_radius > 0` clamps the footprint.
    """
    n = means3d.shape[0]
    opacities = opacities.reshape(n)
    X, Y, Z = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def xform(M):
        return [X * M[0, j] + Y * M[1, j] + Z * M[2, j] + M[3, j]
                for j in range(4)]

    pv = xform(cam.viewmatrix)
    depths = pv[2]

    ph = xform(cam.projmatrix)
    p_w = 1.0 / (ph[3] + 1e-7)

    W, H = cam.width, cam.height
    mx = ((ph[0] * p_w + 1.0) * W - 1.0) * 0.5
    my = ((ph[1] * p_w + 1.0) * H - 1.0) * 0.5
    means2d = torch.stack([mx, my], dim=1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    # --- EWA: world cov -> 2D screen cov (scalar-expanded) ---------------
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    tz = torch.where(torch.abs(depths) < 1e-6,
                     torch.full_like(depths, 1e-6), depths)
    txtz = torch.minimum(torch.maximum(pv[0] / tz, -limx), limx)
    tytz = torch.minimum(torch.maximum(pv[1] / tz, -limy), limy)
    tx, ty = txtz * tz, tytz * tz

    focal_x = W / (2.0 * cam.tan_fovx)
    focal_y = H / (2.0 * cam.tan_fovy)

    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)

    # T = J @ W_r with W_r[k, c] = Vr[c, k] (transposed storage).
    Vr = cam.viewmatrix[:3, :3]
    t0 = [j00 * Vr[c, 0] + j02 * Vr[c, 2] for c in range(3)]
    t1 = [j11 * Vr[c, 1] + j12 * Vr[c, 2] for c in range(3)]

    sxx, sxy, sxz = cov6[:, 0], cov6[:, 1], cov6[:, 2]
    syy, syz, szz = cov6[:, 3], cov6[:, 4], cov6[:, 5]

    def sigma_dot(t):
        return (sxx * t[0] + sxy * t[1] + sxz * t[2],
                sxy * t[0] + syy * t[1] + syz * t[2],
                sxz * t[0] + syz * t[1] + szz * t[2])

    u0 = sigma_dot(t0)
    u1 = sigma_dot(t1)
    cxx = t0[0] * u0[0] + t0[1] * u0[1] + t0[2] * u0[2] + LOWPASS
    cxy = t0[0] * u1[0] + t0[1] * u1[1] + t0[2] * u1[2]
    cyy = t1[0] * u1[0] + t1[1] * u1[1] + t1[2] * u1[2] + LOWPASS

    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=1)

    # Radius: 3 sigma of the max eigenvalue, tightened by the opacity-aware
    # bound sigma*sqrt(2 ln(255 op)) past which alpha < 1/255 (lossless).
    mid = 0.5 * (cxx + cyy)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    sigma_max = torch.sqrt(lam1)
    op_bound = torch.sqrt(
        2.0 * torch.log(torch.clamp(255.0 * opacities, min=1.0 + 1e-6)))
    bound = torch.clamp(op_bound, max=3.0)
    radius_f = torch.ceil(bound * sigma_max)
    rx_f = torch.ceil(bound * torch.sqrt(cxx))
    ry_f = torch.ceil(bound * torch.sqrt(cyy))
    if clamp_radius > 0:
        radius_f = torch.clamp(radius_f, max=float(clamp_radius))
        rx_f = torch.clamp(rx_f, max=float(clamp_radius))
        ry_f = torch.clamp(ry_f, max=float(clamp_radius))

    # --- visibility -------------------------------------------------------
    in_front = depths > ZNEAR
    det_ok = det > 0
    on_screen = (
        (mx + radius_f >= 0)
        & (mx - radius_f < W)
        & (my + radius_f >= 0)
        & (my - radius_f < H)
    )
    visible = in_front & det_ok & on_screen
    if valid is not None:
        visible = visible & valid
    zero = torch.zeros((), dtype=radius_f.dtype, device=radius_f.device)
    radii = torch.where(visible, radius_f, zero).to(torch.int32)
    radii_xy = torch.stack(
        [torch.where(visible, rx_f, zero), torch.where(visible, ry_f, zero)],
        dim=1).to(torch.int32)

    # --- SH -> RGB --------------------------------------------------------
    dirs = means3d - cam.campos[None, :]
    dir_sq = torch.sum(dirs * dirs, dim=1, keepdim=True)
    dirs = dirs / torch.sqrt(torch.clamp(dir_sq, min=1e-24))
    k = sh_lib.num_sh_coeffs(sh_degree)
    rgb = sh_lib.eval_sh(sh_degree, shs[:, :k, :].transpose(1, 2), dirs) + 0.5
    # torch.maximum, not torch.clamp: at rgb == 0 it passes half the
    # gradient, as jnp.maximum does (clamp passes all of it)
    rgb = torch.maximum(rgb, rgb.new_zeros(()))

    return Projected(
        means2d=means2d,
        depths=depths,
        conics=conics,
        radii=radii,
        rgb=rgb,
        opacities=opacities,
        visible=visible,
        radii_xy=radii_xy,
    )


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Frustum test of the rasterizer's markVisible: view-space z > ZNEAR.
    Returns bool [N]. (`projmatrix` is unused, as in the JAX version.)"""
    n = means3d.shape[0]
    homog = torch.cat([means3d, torch.ones((n, 1), dtype=means3d.dtype,
                                           device=means3d.device)], dim=1)
    p_view = homog @ viewmatrix
    return p_view[:, 2] > ZNEAR
