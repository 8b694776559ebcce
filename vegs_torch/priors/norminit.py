"""Covariance-surface alignment initialization from monocular normals (port
of vegs_tpu/priors/norminit.py).

For every training camera, per-pixel surface normals become per-pixel
rotation quaternions (first column = normal); visible Gaussians sample the
quaternion under their projected center (bilinear); each Gaussian sums the
outer products q q^T of its samples across cameras (sign-invariant), and
the most consistent quaternion is that 4x4 sum's principal eigenvector
(the chordal-L2 quaternion mean). Finally the rotation is set from it and
the scale flattened to (1e-5, 1e-1, 1e-1) along the normal.

Everything runs on the field's device: the accumulation per camera, and at
finalize the sums' principal eigenvectors by repeated squaring
(`principal_eigenvector`; the JAX version runs numpy's float32 `eigh` on
the host). Nothing [N, H, W] is built: the
accumulator is [N, 4, 4] and each camera's quaternion map [H, W, 4].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import geometry, resolve_device
from ..gaussians import GaussianField
from ..ops.projection import CameraParams, mark_visible


SQUARINGS = 24  # the principal eigenvector: P <- P @ P / trace, 24 times


class NormalAccumulator(NamedTuple):
    M: torch.Tensor      # [N, 4, 4] quaternion outer-product sums
    count: torch.Tensor  # [N] samples taken

    @staticmethod
    def zeros(n: int, device=None) -> "NormalAccumulator":
        dev = resolve_device(device)
        return NormalAccumulator(
            M=torch.zeros((n, 4, 4), dtype=torch.float32, device=dev),
            count=torch.zeros((n,), dtype=torch.float32, device=dev))


def normal_map_to_quats(normal_world: torch.Tensor) -> torch.Tensor:
    """[3, H, W] world normals -> [H, W, 4] rotation quaternions whose
    rotation's first column is the normal."""
    h, w = normal_world.shape[1:]
    n = normal_world.reshape(3, -1).T
    q = geometry.rotmat_to_quat(geometry.normal_to_rot(n))
    return q.reshape(h, w, 4)


@torch.no_grad()
def accumulate_camera_normals(acc: NormalAccumulator, field: GaussianField,
                              cam: CameraParams,
                              normal_world: torch.Tensor) -> NormalAccumulator:
    """One camera's pass, added into `acc` in place (and returned):
    frustum test, project the centers, sample the camera's quaternion map
    bilinearly, add the outer products of the Gaussians inside the image."""
    means = field.means.detach()
    n = means.shape[0]
    vis = mark_visible(means, cam.viewmatrix, cam.projmatrix) & field.valid

    homog = torch.cat([means, torch.ones((n, 1), dtype=means.dtype,
                                         device=means.device)], dim=1)
    p_hom = homog @ cam.projmatrix
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :2] * p_w[:, None]
    W, H = cam.width, cam.height
    px = ((ndc[:, 0] + 1.0) * W - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5

    inb = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    mask = (vis & inb).to(torch.float32)

    qmap = normal_map_to_quats(normal_world)  # [H, W, 4]

    # Bilinear sample (grid_sample's corners). The corner indices are
    # clamped before the integer cast, so centers far off screen (masked
    # out) never overflow it.
    x0f = torch.clamp(torch.floor(px), 0, W - 1)
    y0f = torch.clamp(torch.floor(py), 0, H - 1)
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = torch.clamp(px - x0f, 0.0, 1.0)[:, None]
    fy = torch.clamp(py - y0f, 0.0, 1.0)[:, None]
    q = (qmap[y0, x0] * (1 - fx) * (1 - fy)
         + qmap[y0, x1] * fx * (1 - fy)
         + qmap[y1, x0] * (1 - fx) * fy
         + qmap[y1, x1] * fx * fy)
    q = geometry.quat_normalize(q)

    outer = q[:, :, None] * q[:, None, :]  # sign-invariant
    acc.M.add_(outer * mask[:, None, None])
    acc.count.add_(mask)
    return acc


def principal_eigenvector(M: torch.Tensor) -> torch.Tensor:
    """Unit eigenvectors [B, 4] of the largest eigenvalue of symmetric PSD
    [B, 4, 4] matrices, up to sign: the matrix squared SQUARINGS times,
    scaled to unit trace each time, is ~v v^T once (lambda_2 /
    lambda_1)^(2^squarings) is negligible (below 1e-6 for any eigengap
    above 1e-6 of lambda_1 at 24 squarings); v is its column of largest
    diagonal, normalized. Where the two largest eigenvalues coincide the
    eigenvector is not defined, and this returns some unit vector of
    their plane. (`torch.linalg.eigh` is exact but, on a CUDA card, its
    batched cuSOLVER call refuses batches of ~10^5-10^6 small matrices.)"""
    P = M / torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    for _ in range(SQUARINGS):
        P = P @ P
        P = P / torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    diag = torch.diagonal(P, dim1=-2, dim2=-1)
    j = torch.argmax(diag, dim=-1)
    col = torch.gather(P, 2, j[:, None, None].expand(-1, 4, 1))[..., 0]
    return col / torch.linalg.norm(col, dim=-1, keepdim=True)


@torch.no_grad()
def finalize_normal_init(field: GaussianField, acc: NormalAccumulator,
                         flat_scales=(1e-5, 1e-1, 1e-1)) -> GaussianField:
    """Set the rotation of every Gaussian that took at least one sample to
    its sums' principal eigenvector (sign flipped so that w >= 0) and its
    scales to `flat_scales`, in place on `field` (returned)."""
    has = acc.count > 0
    best = principal_eigenvector(acc.M[has])
    best = torch.where(best[:, :1] < 0, -best, best)
    field.quats[has] = best
    log_s = torch.from_numpy(np.log(np.asarray(flat_scales, np.float32)))
    field.log_scales[has] = log_s.to(field.log_scales.device)
    return field


def accumulate_cameras(field: GaussianField, cameras) -> NormalAccumulator:
    """Every camera's pass, on the field's device. Each camera provides
    `device_params(device)` and `world_normal()`; cameras whose
    `world_normal()` is None are skipped."""
    dev = field.means.device
    acc = NormalAccumulator.zeros(field.capacity, dev)
    for cam in cameras:
        nw = cam.world_normal()
        if nw is None:
            continue
        accumulate_camera_normals(
            acc, field, cam.device_params(dev),
            torch.from_numpy(np.asarray(nw, np.float32)).to(dev))
    return acc


def initialize_gaussians_with_window_normals(
        field: GaussianField, cameras, flat_scales=(1e-5, 1e-1, 1e-1)
) -> GaussianField:
    """The whole init over a camera list (`accumulate_cameras`, then
    `finalize_normal_init`): updates `field`'s quats and log_scales in
    place and returns it."""
    return finalize_normal_init(field, accumulate_cameras(field, cameras),
                                flat_scales)
