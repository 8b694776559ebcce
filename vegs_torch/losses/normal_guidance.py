"""Covariance-surface alignment loss (port of
vegs_tpu/losses/normal_guidance.py):

  loss = 0.8 * mean|<R_cols, n>| + 0.2 * mean|<(detach(R) * s)_cols, n>|

where R and s are the rasterizer's per-pixel covariance rotation and scale
maps and n the prior's unit normals; the rotation is detached in the scale
term, as in the reference.
"""

from __future__ import annotations

import torch

from .. import geometry


def loss_normal_guidance(
    render_cov_quat: torch.Tensor,   # [4, H, W]
    render_cov_scale: torch.Tensor,  # [3, H, W]
    normal_pred: torch.Tensor,       # [3, H, W] unit normals (world space)
    mask: torch.Tensor | None = None,  # [H, W] optional validity
) -> torch.Tensor:
    q = render_cov_quat.reshape(4, -1).T          # [P, 4]
    s = render_cov_scale.reshape(3, -1).T         # [P, 3]
    n = normal_pred.reshape(3, -1).T              # [P, 3]

    R = geometry.quat_to_rotmat(q)                # [P, 3, 3]
    term_rot = torch.mean(torch.abs(torch.einsum("pi,pij->pj", n, R)), dim=1)
    Rs = R.detach() * s[:, None, :]               # rotation detached
    term_scale = torch.mean(torch.abs(torch.einsum("pi,pij->pj", n, Rs)), dim=1)

    per_pixel = 0.8 * term_rot + 0.2 * term_scale
    if mask is not None:
        m = mask.reshape(-1).to(per_pixel.dtype)
        return torch.sum(per_pixel * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(per_pixel)
