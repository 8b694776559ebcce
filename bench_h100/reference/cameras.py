"""Camera matrices of the plain reference, in float64 from the benchmark's
poses: the world-to-view transform, the principal-point-aware perspective
projection (znear 0.01, zfar 100, the 3DGS convention: clip w = view z),
the trajectory's interpolation (SLERP of the camera-to-world rotation,
lerp of the centre) and the fixed extrapolation augmentations (a pitch in
the camera frame, a yaw about the world z axis, a rise along world z)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

ZNEAR, ZFAR = 0.01, 100.0


class View(NamedTuple):
    """A camera as the reference uses it (float64)."""

    w2c: np.ndarray   # [4, 4] world -> view (column vectors)
    proj: np.ndarray  # [4, 4] view -> clip
    center: np.ndarray  # [3]
    fx: float
    fy: float
    height: int
    width: int


def c2w_of(r_w2c: np.ndarray, center: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.asarray(r_w2c, np.float64).T
    m[:3, 3] = center
    return m


def projection(k: np.ndarray, height: int, width: int) -> np.ndarray:
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    tanx, tany = width / (2 * fx), height / (2 * fy)
    top, right = tany * ZNEAR, tanx * ZNEAR
    dx = (cx - width / 2) / fx * ZNEAR
    dy = (cy - height / 2) / fy * ZNEAR
    t, b, l, r = top + dy, -top + dy, -right + dx, right + dx
    p = np.zeros((4, 4))
    p[0, 0] = 2 * ZNEAR / (r - l)
    p[1, 1] = 2 * ZNEAR / (t - b)
    p[0, 2] = (r + l) / (r - l)
    p[1, 2] = (t + b) / (t - b)
    p[3, 2] = 1.0
    p[2, 2] = (ZFAR + ZNEAR) / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def view(c2w: np.ndarray, k: np.ndarray, height: int, width: int) -> View:
    return View(np.linalg.inv(c2w), projection(k, height, width),
                c2w[:3, 3].copy(), float(k[0, 0]), float(k[1, 1]),
                int(height), int(width))


def _quat(m: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z), w >= 0, of a rotation matrix."""
    w = np.sqrt(max(0.0, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    x = np.sqrt(max(0.0, 1 + m[0, 0] - m[1, 1] - m[2, 2])) / 2
    y = np.sqrt(max(0.0, 1 - m[0, 0] + m[1, 1] - m[2, 2])) / 2
    z = np.sqrt(max(0.0, 1 - m[0, 0] - m[1, 1] + m[2, 2])) / 2
    x = np.copysign(x, m[2, 1] - m[1, 2])
    y = np.copysign(y, m[0, 2] - m[2, 0])
    z = np.copysign(z, m[1, 0] - m[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    theta = np.arccos(min(d, 1.0))
    if np.sin(theta) < 1e-6:
        q = (1 - t) * q0 + t * q1
    else:
        q = (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)
    return q / np.linalg.norm(q)


def interpolate(c2ws: list, n_interp: int) -> list:
    """Camera-to-world matrices of the trajectory through `c2ws`: n_interp
    per consecutive pair (t = k / n_interp), then the last one."""
    out = []
    for a, b in zip(c2ws[:-1], c2ws[1:]):
        qa, qb = _quat(a[:3, :3]), _quat(b[:3, :3])
        for k in range(n_interp):
            t = k / n_interp
            m = np.eye(4)
            m[:3, :3] = _rotmat(slerp(qa, qb, t))
            m[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(m)
    out.append(c2ws[-1])
    return out


def augment(c2w: np.ndarray, add_xrot_val=0.0, add_zrot_val=0.0,
            add_tz=0.0) -> np.ndarray:
    px, pz = np.deg2rad(add_xrot_val), np.deg2rad(add_zrot_val)
    rx = np.array([[1, 0, 0], [0, np.cos(px), -np.sin(px)],
                   [0, np.sin(px), np.cos(px)]])
    rz = np.array([[np.cos(pz), -np.sin(pz), 0], [np.sin(pz), np.cos(pz), 0],
                   [0, 0, 1]])
    m = c2w.copy()
    m[:3, :3] = rz @ (m[:3, :3] @ rx)
    m[2, 3] += add_tz
    return m


def scene_extent(centers: list) -> float:
    """The learning rates' spatial scale: 1.1 times the largest distance of
    a camera centre from their mean."""
    c = np.stack(centers)
    return float(np.max(np.linalg.norm(c - c.mean(0), axis=1)) * 1.1)
