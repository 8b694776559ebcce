"""Scene/dataset records (port of vegs_tpu/scene/dataset_readers.py, subset).

The CameraInfo/SceneInfo containers, the FoV helpers, the nerf++
normalization, `camera_from_info` and the random virtual rig
(`generateRandomCameras`). The KITTI-360, KITTI, COLMAP and Blender
loaders wait for a later slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np

from .. import geometry
from .cameras import Camera, resolve_resolution


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: Optional[np.ndarray] = None


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: Optional[np.ndarray]
    image_path: str
    image_name: str
    width: int
    height: int
    K: Optional[np.ndarray] = None
    normal: Optional[np.ndarray] = None
    normal_path: str = ""
    frame: int = 0
    cam_idx: int = 0


@dataclass
class SceneInfo:
    point_cloud: Optional[BasicPointCloud]
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str
    dyn_point_cloud: Optional[object] = None
    train_bboxes: dict = field(default_factory=dict)
    test_bboxes: dict = field(default_factory=dict)
    instances_info: list = field(default_factory=list)


def focal2fov(focal, pixels):
    return 2 * np.arctan(pixels / (2 * focal))


def fov2focal(fov, pixels):
    return pixels / (2 * np.tan(fov / 2))


def getNerfppNorm(cam_infos, pcd: Optional[BasicPointCloud] = None) -> dict:
    """Camera(+point) bounding radius for LR scaling."""
    centers = []
    for cam in cam_infos:
        w2c = geometry.world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3:4])
    centers = np.hstack(centers)
    if pcd is not None:
        centers = np.concatenate([pcd.points.T, centers], axis=1)
    center = np.mean(centers, axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - center, axis=0))
    return {"translate": -center.flatten(), "radius": diagonal * 1.1}


def generateRandomCameras(n_views, elevation_deg=0.0, camera_distance=2.0,
                          fov=45.0, width=256, height=256,
                          rng: np.random.Generator | None = None) -> list[CameraInfo]:
    """`n_views` cameras on a circle around the origin, looking at it, at
    jittered azimuths (the reference's random virtual rig)."""
    rng = rng or np.random.default_rng(0)
    azimuth = (np.linspace(0, 360, n_views + 1)[:-1]
               + rng.random(n_views) * 360.0 / n_views)
    azimuth = np.deg2rad(azimuth)
    elev = np.deg2rad(np.full_like(azimuth, elevation_deg))
    centers = np.stack([
        camera_distance * np.cos(elev) * np.cos(azimuth),
        camera_distance * np.cos(elev) * np.sin(azimuth),
        camera_distance * np.sin(elev),
    ], axis=-1)
    fov_rad = np.deg2rad(fov)
    infos = []
    for i, c in enumerate(centers):
        forward = -c / np.linalg.norm(c)               # look at the origin
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R_w2c = np.stack([right, down, forward], axis=0)
        T = -R_w2c @ c
        K = np.array([
            [fov2focal(fov_rad, width), 0, width / 2],
            [0, fov2focal(fov_rad, height), height / 2],
            [0, 0, 1],
        ])
        infos.append(CameraInfo(
            uid=i, R=R_w2c.T, T=T, FovY=fov_rad, FovX=fov_rad,
            image=None, image_path="", image_name=f"random_{i:03d}",
            width=width, height=height, K=K,
        ))
    return infos


def camera_from_info(info: CameraInfo, preload: bool = False,
                     resolution: int = -1,
                     resolution_scale: float = 1.0) -> Camera:
    """Camera from a CameraInfo record, under the reference's resolution
    policy (intrinsics scale with the image; FoV does not). Resizing a
    preloaded image or normal map needs OpenCV, imported only then."""
    K = info.K
    if K is None:
        K = np.array([
            [fov2focal(info.FovX, info.width), 0, info.width / 2],
            [0, fov2focal(info.FovY, info.height), info.height / 2],
            [0, 0, 1.0],
        ])
    tw, th = resolve_resolution(info.width, info.height, resolution,
                                resolution_scale)
    if (tw, th) != (info.width, info.height):
        K = K * np.array([[tw / info.width], [th / info.height], [1.0]])
    image = info.image
    if image is not None and image.shape[-2:] != (th, tw):
        import cv2

        image = cv2.resize(
            np.asarray(image).transpose(1, 2, 0), (tw, th),
            interpolation=cv2.INTER_AREA).transpose(2, 0, 1)
    if preload and image is None and info.image_path and os.path.exists(info.image_path):
        raise NotImplementedError("loading images from disk is not ported yet")
    normal = info.normal
    if normal is not None and normal.shape[-2:] != (th, tw):
        import cv2

        normal = cv2.resize(
            np.asarray(normal).transpose(1, 2, 0), (tw, th),
            interpolation=cv2.INTER_LINEAR).transpose(2, 0, 1)
    return Camera(
        colmap_id=info.uid, R=info.R, T=info.T, FoVx=info.FovX, FoVy=info.FovY,
        K=K, image_name=info.image_name, image_path=info.image_path,
        normal_path=info.normal_path, uid=info.uid, frame=info.frame,
        image_width=tw, image_height=th,
        image=image, normal=normal,
    )
