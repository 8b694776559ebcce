"""Synthetic street camera rigs (numpy copy of the camera arc of
vegs_tpu/utils/synthetic.py) and a synthetic normal map. The ray-traced
ground truth of that module is not ported: the records carry no images, and
callers render their own ground truth."""

from __future__ import annotations

import numpy as np

from ..scene.dataset_readers import CameraInfo, fov2focal


def street_camera_infos(n: int, H: int, W: int, fovx=1.2, fovy=0.7,
                        stereo_baseline=0.0):
    """Forward-facing camera arc (KITTI-like ego motion with slight yaw) as
    CameraInfo records without images; the same poses as the JAX package's
    `street_camera_infos(..., render_gt=False)`. `stereo_baseline > 0`
    emits two cameras per frame offset +-baseline/2 along the camera x axis."""
    infos = []
    uid = 0
    for i in range(n):
        zc = -2.5 + 2.5 * i / max(n - 1, 1)
        yaw = 0.12 * np.sin(2 * np.pi * i / max(n, 1))
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rw2c = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
        C0 = np.array([0.25 * np.sin(i * 1.7), 0.0, zc])
        K = np.array([
            [fov2focal(fovx, W), 0, W / 2],
            [0, fov2focal(fovy, H), H / 2],
            [0, 0, 1.0],
        ])
        eyes = ([0.0] if stereo_baseline <= 0
                else [-stereo_baseline / 2, stereo_baseline / 2])
        for ei, dx in enumerate(eyes):
            C = C0 + Rw2c[0] * dx
            T = -Rw2c @ C
            suffix = f"_{ei}" if stereo_baseline > 0 else ""
            infos.append(CameraInfo(
                uid=uid, R=Rw2c.T, T=T, FovX=fovx, FovY=fovy, K=K,
                image=None, image_path="",
                image_name=f"street_{i:03d}{suffix}",
                normal=None, normal_path="", width=W, height=H, frame=i))
            uid += 1
    return infos


def unit_normal_map(H: int, W: int, seed: int = 0) -> np.ndarray:
    """A smooth synthetic camera-space normal map [3, H, W] of unit vectors
    (a tilted plane with seeded low-frequency ripples), for training steps
    that exercise the normal-guidance loss without a normal prior."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    fx, fy, ph = rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0), rng.uniform(0, 6.3)
    nx = 0.3 * np.sin(2 * np.pi * fx * x / W + ph)
    ny = -0.8 + 0.2 * np.cos(2 * np.pi * fy * y / H)
    nz = -np.ones_like(x)
    n = np.stack([nx, ny, nz]).astype(np.float32)
    return n / np.linalg.norm(n, axis=0, keepdims=True)
