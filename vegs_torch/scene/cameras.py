"""Host-side camera objects and view augmentation (port of
vegs_tpu/scene/cameras.py).

All pose math is numpy on the host; `device_params(device)` produces the
port's CameraParams. A camera holds its image and normal map in memory, or
loads them from disk on each read (`original_image`, `original_normal`):
images with PIL (imported on first read), normal maps with `np.load`, and
OpenCV imported only to resize a normal map whose size differs from the
camera's. `augment_camera` is the random extrapolated view
of diffusion guidance, `make_camera_like_input_camera` its deterministic
eval/video form. `MiniCam` is the remote viewer's camera (`viewer.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import geometry, resolve_device
from ..ops.projection import CameraParams
from ..utils import trace

ZFAR = 100.0
ZNEAR = 0.01


def _load_image(path: str, size_wh=None) -> np.ndarray:
    """An image as [3, H, W] float32 in [0, 1] (gray repeated, alpha
    dropped, a palette expanded to RGB), resized with PIL's LANCZOS to
    `size_wh` (W, H) if it differs."""
    from PIL import Image

    img = Image.open(path)
    if img.mode == "P":
        img = img.convert("RGB")
    if size_wh is not None and img.size != tuple(size_wh):
        img = img.resize(tuple(size_wh), Image.LANCZOS)
    img = np.asarray(img, dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return np.clip(img[..., :3].transpose(2, 0, 1), 0.0, 1.0)  # [3, H, W]


def _load_normal(path: str, size_wh) -> np.ndarray:
    """A *_norm.npy omnidata normal map ([3, h, w] or [h, w, 3]) as [3, H,
    W] float32, resized bilinearly by OpenCV to `size_wh` (W, H) if it
    differs (cv2 imported only then)."""
    n = np.load(path).astype(np.float32)
    if n.shape[0] == 3:
        n = n.transpose(1, 2, 0)
    w, h = size_wh
    if (n.shape[1], n.shape[0]) != (w, h):
        import cv2

        n = cv2.resize(n, (w, h), interpolation=cv2.INTER_LINEAR)
    return n.transpose(2, 0, 1)


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
        """The image in memory, or read from `image_path` at the camera's
        (possibly policy-downscaled) size."""
        if self.image is not None:
            return self.image
        return _load_image(self.image_path,
                           (self.image_width, self.image_height))

    @property
    def original_normal(self) -> Optional[np.ndarray]:
        """The normal map in memory, or read from `normal_path` (None
        without either)."""
        if self.normal is not None:
            return self.normal
        if not self.normal_path:
            return None
        return _load_normal(self.normal_path,
                            (self.image_width, self.image_height))

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

        with trace.span("camera.copy", sync=True):  # five pageable copies
            return CameraParams(
                viewmatrix=f32(self.world_view_transform),
                projmatrix=f32(self.full_proj_transform),
                campos=f32(self.camera_center),
                tan_fovx=f32(np.tan(self.FoVx * 0.5)),
                tan_fovy=f32(np.tan(self.FoVy * 0.5)),
                height=int(self.image_height),
                width=int(self.image_width),
            )

    def resized(self, image_size: int) -> "Camera":
        """The camera scaled so that its height is `image_size` (intrinsics
        with it; no pixels held)."""
        r = image_size / self.image_height
        return dataclasses.replace(
            self,
            K=self.K * r,
            image=None,
            normal=None,
            image_height=int(image_size),
            image_width=int(r * self.image_width),
        )


@dataclasses.dataclass
class MiniCam:
    """The remote viewer's camera: size, fields of view, clip planes and
    the row-vector (glm layout) view and view-projection matrices."""

    image_width: int
    image_height: int
    FoVy: float
    FoVx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray

    def __post_init__(self):
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]


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


def augment_camera(cam: Camera, cfg_sd, rng: np.random.Generator,
                   eval: bool = False):
    """Random extrapolated view for diffusion guidance: a yaw about the
    world z-axis (left or right), a downward pitch in the camera frame and
    a rise along world z, drawn from `rng` in `cfg_sd`'s ranges (its eval
    values with `eval=True`), then resized to cfg_sd.sd_image_size.
    Returns (camera, yaw_deg, pitch_deg, t_z, yaw_dir)."""
    c2w = _c2w(cam)
    if eval:
        yaw_deg = cfg_sd.yaw_eval
        pitch_deg = cfg_sd.pitch_eval
        t_z = cfg_sd.trans_z_eval
        yaw_dir = None
    else:
        yaw_dir = int(rng.choice([1, -1]))
        yaw_deg = yaw_dir * rng.uniform(cfg_sd.yaw_start, cfg_sd.yaw_end)
        pitch_deg = -1 * rng.uniform(cfg_sd.pitch_start, cfg_sd.pitch_end)
        t_z = rng.uniform(0, cfg_sd.trans_z_range)

    c2w = c2w.copy()
    c2w[:3, :3] = c2w[:3, :3] @ _rot_x(pitch_deg)   # pitch in camera frame
    c2w[:3, :3] = _rot_z(yaw_deg) @ c2w[:3, :3]     # yaw in world frame
    c2w[2, 3] += t_z                                # rise along world z

    aug = _rebuild(cam, c2w)
    aug = aug.resized(cfg_sd.sd_image_size)
    return aug, yaw_deg, pitch_deg, t_z, yaw_dir


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
