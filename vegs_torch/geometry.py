"""Quaternion / rigid-transform / projection math (port of vegs_tpu/geometry.py).

Conventions are the JAX package's: quaternions are (w, x, y, z); world-to-
view matrices follow the COLMAP/3DGS convention and are stored transposed by
the camera objects. The tensor functions are shape-polymorphic over leading
batch dims; the camera-matrix helpers are numpy copies.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Quaternion algebra
# ---------------------------------------------------------------------------


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4]; the eps floor keeps zero-padded
    slots finite (and their gradient NaN-free)."""
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    return q / torch.sqrt(torch.clamp(sq, min=eps * eps))


def quat_standardize(q: torch.Tensor) -> torch.Tensor:
    """Make the real part non-negative (q and -q encode the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4] x [..., 4] -> [..., 4]."""
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def _rot_entries(q: torch.Tensor):
    w, x, y, z = torch.unbind(q, dim=-1)
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [..., 4] (w,x,y,z), normalized first -> [..., 3, 3]."""
    r = _rot_entries(quat_normalize(q))
    rows = [torch.stack(r[3 * i:3 * i + 3], dim=-1) for i in range(3)]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w,x,y,z):
    branchless Shepperd-style selection of the best-conditioned candidate."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs2 = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs2, min=1e-12))

    cand_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1)
    cand_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1)
    cand_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1)
    cand_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    denom = 2.0 * torch.clamp(q_abs[..., None], min=0.1)
    cands = cands / denom

    best = torch.argmax(q_abs2, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_standardize(quat_normalize(q))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t + torch.zeros_like(theta),
                     torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t + torch.zeros_like(theta),
                     torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# Scaling-rotation covariance factors
# ---------------------------------------------------------------------------


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s): [..., 3] x [..., 4] -> [..., 3, 3]."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def covariance_from_scaling_rotation(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Full 3D covariance Sigma = L L^T, [..., 3, 3]."""
    L = build_scaling_rotation(scales * scale_modifier, quats)
    return L @ L.transpose(-1, -2)


def cov6_from_scaling_rotation(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Packed covariance (xx, xy, xz, yy, yz, zz) in scalar form:
    Sigma_ij = sum_k s_k^2 R_ik R_jk (no [..., 3, 3] intermediates)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_entries(
        quat_normalize(quats))
    s = scales * scale_modifier
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> 6 unique values (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unstrip_symmetric(six: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric."""
    xx, xy, xz, yy, yz, zz = torch.unbind(six, dim=-1)
    row0 = torch.stack([xx, xy, xz], -1)
    row1 = torch.stack([xy, yy, yz], -1)
    row2 = torch.stack([xz, yz, zz], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def decompose_T_to_RS(T: torch.Tensor):
    """[..., 4, 4] rigid+scale transform -> (R [...,3,3], S [...,3], t [...,3])
    by column norms."""
    A = T[..., :3, :3]
    S = torch.linalg.norm(A, dim=-2)
    R = A / torch.clamp(S[..., None, :], min=1e-12)
    t = T[..., :3, 3]
    return R, S, t


def compose_T(R: torch.Tensor, S: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, S, t) -> 4x4 transform with A = R @ diag(S)."""
    A = R * S[..., None, :]
    top = torch.cat([A, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Camera matrices (numpy, host side)
# ---------------------------------------------------------------------------


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4. `R` is the cam-to-world rotation stored transposed
    (3DGS convention); `t` is the COLMAP translation. Optional recentring
    (translate/scale) matches getWorld2View2."""
    Rt = np.zeros((4, 4), dtype=np.float32)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(
    znear: float,
    zfar: float,
    fovx: float,
    fovy: float,
    cx_offset: float = 0.0,
    cy_offset: float = 0.0,
) -> np.ndarray:
    """OpenGL-style perspective projection used by 3DGS, with optional
    normalized principal-point offsets in [-1, 1] NDC units."""
    tanx = float(np.tan(fovx * 0.5))
    tany = float(np.tan(fovy * 0.5))
    top = tany * znear
    bottom = -top
    right = tanx * znear
    left = -right
    right += cx_offset * tanx * znear
    left += cx_offset * tanx * znear
    top += cy_offset * tany * znear
    bottom += cy_offset * tany * znear

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def projection_matrix_from_K(
    znear: float, zfar: float, fovx: float, fovy: float,
    fx: float, fy: float, cx: float, cy: float, w: float, h: float,
) -> np.ndarray:
    """Principal-point-aware projection (getProjectionMatrixwithPrincipal-
    PointOffset semantics, including its (zfar+znear)/(zfar-znear) row)."""
    tany = np.tan(fovy * 0.5)
    tanx = np.tan(fovx * 0.5)
    top_c = tany * znear
    right_c = tanx * znear
    dx = (cx - w / 2) / fx * znear
    dy = (cy - h / 2) / fy * znear
    top, bottom = top_c + dy, -top_c + dy
    left, right = -right_c + dx, right_c + dx
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov * 0.5))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


# ---------------------------------------------------------------------------
# Normal-map helpers (for the covariance-surface alignment prior)
# ---------------------------------------------------------------------------


def normal_to_rot(normals: torch.Tensor) -> torch.Tensor:
    """Rotation matrices whose FIRST column is the given normal
    (normalized), the other columns an orthonormal completion built from
    a helper axis: x when |n_x| < 0.9, else y. [..., 3] -> [..., 3, 3]."""
    n = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                              min=1e-12)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where(torch.abs(n[..., :1]) < 0.9, ex.expand_as(n),
                      ey.expand_as(n))
    b = torch.linalg.cross(n, ref, dim=-1)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)
    c = torch.linalg.cross(n, b, dim=-1)
    return torch.stack([n, b, c], dim=-1)  # columns


def cam_normal_to_world_normal(normals_cam: torch.Tensor,
                               R_c2w: torch.Tensor) -> torch.Tensor:
    """Camera-space normals [..., 3] rotated into world space by the
    camera-to-world rotation R_c2w [3, 3] (`Camera.R`, 3DGS convention)."""
    return normals_cam @ R_c2w.T
