"""Real spherical harmonics up to degree 3 (port of vegs_tpu/sh.py)."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

MAX_SH_DEGREE = 3


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions.

    sh:   [..., C, (degree+1)**2] coefficients (C channels, typically 3)
    dirs: [..., 3] unit view directions
    returns [..., C]
    """
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} outside [0, {MAX_SH_DEGREE}]")
    result = C0 * sh[..., 0]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (
            result
            - C1 * y * sh[..., 1]
            + C1 * z * sh[..., 2]
            - C1 * x * sh[..., 3]
        )
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4]
                + C2[1] * yz * sh[..., 5]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + C2[3] * xz * sh[..., 7]
                + C2[4] * (xx - yy) * sh[..., 8]
            )
            if degree >= 3:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + C3[1] * xy * z * sh[..., 10]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + C3[5] * z * (xx - yy) * sh[..., 14]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
    return result


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values at unit directions: [..., 3] -> [..., (degree+1)**2];
    eval_sh(deg, sh, d) == einsum('...ck,...k->...c', sh, sh_basis(deg, d))."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} outside [0, {MAX_SH_DEGREE}]")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    basis = [C0 * torch.ones_like(x)]
    if degree >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if degree >= 3:
                basis += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
    return torch.stack(basis, dim=-1)


def rgb_to_sh(rgb):
    """Colors in [0,1] -> DC SH coefficient."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5
