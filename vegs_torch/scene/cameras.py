"""Host-side camera objects (port of vegs_tpu/scene/cameras.py, subset).

All pose math is numpy on the host; `device_params(device)` produces the
port's CameraParams. Images and normal maps are those held in memory; lazy
loading from disk (PIL) and the random diffusion-guidance augmentation wait
for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import geometry, resolve_device
from ..ops.projection import CameraParams

ZFAR = 100.0
ZNEAR = 0.01


def resolve_resolution(orig_w: int, orig_h: int, resolution: int = -1,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """The reference's loadCam resolution policy: divisors 1/2/4/8 scale
    directly; -1 auto-downscales >1600 px-wide images to 1600; any other
    positive value is a target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1.0
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


@dataclasses.dataclass
class Camera:
    """One view. `R` is the transposed world-to-camera rotation (3DGS
    convention); `T` the w2c translation."""

    colmap_id: int
    R: np.ndarray            # [3, 3]
    T: np.ndarray            # [3]
    FoVx: float
    FoVy: float
    K: np.ndarray            # [3, 3] intrinsics (pixels)
    image_name: str = ""
    image_path: str = ""
    normal_path: str = ""
    uid: int = 0
    frame: int = 0
    image_width: int = 0
    image_height: int = 0
    image: Optional[np.ndarray] = None    # [3, H, W] in [0,1], preloaded
    normal: Optional[np.ndarray] = None   # [3, H, W]
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 1.0
    znear: float = ZNEAR
    zfar: float = ZFAR

    def __post_init__(self):
        if self.image is not None:
            self.image = np.clip(self.image, 0.0, 1.0)
            self.image_height, self.image_width = self.image.shape[-2:]
        if not (self.image_width and self.image_height):
            raise ValueError("camera needs image dims")
        self._recompute()

    def _recompute(self):
        self.world_view_transform = geometry.world_to_view(
            self.R, self.T, self.trans, self.scale
        ).T  # stored transposed
        self.projection_matrix = geometry.projection_matrix_from_K(
            self.znear, self.zfar, self.FoVx, self.FoVy,
            self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2],
            self.image_width, self.image_height,
        ).T
        self.full_proj_transform = self.world_view_transform @ self.projection_matrix
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]

    @property
    def original_image(self) -> np.ndarray:
        if self.image is None:
            raise NotImplementedError(
                f"camera {self.image_name!r} holds no image; loading images "
                "from disk is not ported yet")
        return self.image

    @property
    def original_normal(self) -> Optional[np.ndarray]:
        if self.normal is None and self.normal_path:
            raise NotImplementedError("loading normal maps from disk is not "
                                      "ported yet")
        return self.normal

    def world_normal(self) -> Optional[np.ndarray]:
        """Camera-space prior normals rotated to world space (None without
        a normal map)."""
        n = self.original_normal
        if n is None:
            return None
        flat = n.reshape(3, -1).T @ self.R.T
        return flat.T.reshape(n.shape)

    def device_params(self, device=None) -> CameraParams:
        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return CameraParams(
            viewmatrix=f32(self.world_view_transform),
            projmatrix=f32(self.full_proj_transform),
            campos=f32(self.camera_center),
            tan_fovx=f32(np.tan(self.FoVx * 0.5)),
            tan_fovy=f32(np.tan(self.FoVy * 0.5)),
            height=int(self.image_height),
            width=int(self.image_width),
        )


def _c2w(cam: Camera) -> np.ndarray:
    w2c = np.eye(4)
    w2c[:3, :3] = cam.R.T
    w2c[:3, 3] = np.ravel(cam.T)
    return np.linalg.inv(w2c)


def _rebuild(cam: Camera, c2w: np.ndarray, **overrides) -> Camera:
    w2c = np.linalg.inv(c2w)
    return dataclasses.replace(
        cam, R=w2c[:3, :3].T.copy(), T=w2c[:3, 3].copy(), **overrides
    )


def _rot_x(deg: float) -> np.ndarray:
    p = np.deg2rad(deg)
    return np.array([[1, 0, 0],
                     [0, np.cos(p), -np.sin(p)],
                     [0, np.sin(p), np.cos(p)]])


def _rot_z(deg: float) -> np.ndarray:
    p = np.deg2rad(deg)
    return np.array([[np.cos(p), -np.sin(p), 0],
                     [np.sin(p), np.cos(p), 0],
                     [0, 0, 1]])


def make_camera_like_input_camera(cam: Camera, add_xrot_val: float = 0,
                                  add_zrot_val: float = 0,
                                  add_tz: float = 0) -> Camera:
    """Deterministic augmentation for eval/video: pitch in the camera frame,
    rotation about the world z-axis, rise along world z."""
    c2w = _c2w(cam).copy()
    c2w[:3, :3] = c2w[:3, :3] @ _rot_x(add_xrot_val)
    c2w[:3, :3] = _rot_z(add_zrot_val) @ c2w[:3, :3]
    c2w[2, 3] += add_tz
    return _rebuild(cam, c2w)
