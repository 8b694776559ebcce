"""Scene: cameras + the trained static Gaussian field
(port of vegs_tpu/scene/__init__.py, subset).

Weights-only PLY snapshots in the reference's attribute layout: a PLY
written by the JAX package's `save_gaussian_ply` loads here unchanged, and
the other way round. A Scene is built from a given SceneInfo, with the
static field of a trained iteration or seeded from the SceneInfo's point
cloud (`create_from_points`); the dataset loaders and the dynamic box
fields wait for later slices.
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Optional

import numpy as np

from .. import gaussians, resolve_device
from ..gaussians import GaussianField
from . import ply_io
from .cameras import Camera
from .dataset_readers import SceneInfo, camera_from_info

GAUSSIAN_PLY_COMMENT = "vegs_tpu gaussian field"


def save_gaussian_ply(path, field: GaussianField) -> None:
    """Write the reference's Gaussian PLY attribute layout."""
    arrs = gaussians.to_ply_arrays(field)
    cols = {}
    xyz = arrs["xyz"]
    for i, name in enumerate("xyz"):
        cols[name] = xyz[:, i]
    for i, name in enumerate(["nx", "ny", "nz"]):
        cols[name] = arrs["normals"][:, i]
    for i in range(arrs["f_dc"].shape[1]):
        cols[f"f_dc_{i}"] = arrs["f_dc"][:, i]
    for i in range(arrs["f_rest"].shape[1]):
        cols[f"f_rest_{i}"] = arrs["f_rest"][:, i]
    cols["opacity"] = arrs["opacities"][:, 0]
    for i in range(3):
        cols[f"scale_{i}"] = arrs["scale"][:, i]
    for i in range(4):
        cols[f"rot_{i}"] = arrs["rotation"][:, i]
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    ply_io.write_ply(path, ply_io.make_vertex_array(cols),
                     comments=(GAUSSIAN_PLY_COMMENT,))


def load_gaussian_ply(path, capacity: Optional[int] = None,
                      device=None) -> GaussianField:
    v = ply_io.read_ply(path)["vertex"]
    names = v.dtype.names
    n_rest = len([n for n in names if n.startswith("f_rest_")])
    xyz = np.vstack([v["x"], v["y"], v["z"]]).T
    f_dc = np.vstack([v[f"f_dc_{i}"] for i in range(3)]).T
    f_rest = (
        np.vstack([v[f"f_rest_{i}"] for i in range(n_rest)]).T
        if n_rest else np.zeros((len(xyz), 45), np.float32)
    )
    opac = np.asarray(v["opacity"])
    scale = np.vstack([v[f"scale_{i}"] for i in range(3)]).T
    rot = np.vstack([v[f"rot_{i}"] for i in range(4)]).T
    return gaussians.from_ply_arrays(xyz, f_dc, f_rest, opac, scale, rot,
                                     capacity=capacity,
                                     device=resolve_device(device))


class Scene:
    """Cameras of a SceneInfo + the static field: that of a trained
    iteration (`model_path/point_cloud/iteration_<i>/point_cloud.ply`; -1 =
    latest), or with `load_iteration=None` one seeded from the SceneInfo's
    point cloud."""

    def __init__(
        self,
        model_path,
        scene_info: SceneInfo,
        load_iteration: Optional[int] = -1,
        shuffle: bool = True,
        preload_image: bool = False,
        resolution: int = -1,
        device=None,
    ):
        if scene_info.instances_info:
            raise NotImplementedError(
                "dynamic box instances are not ported yet")
        self.model_path = str(model_path)
        self.device = resolve_device(device)
        self.scene_info = scene_info
        if shuffle:
            random.shuffle(scene_info.train_cameras)
        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.train_cameras = [
            camera_from_info(c, preload=preload_image, resolution=resolution)
            for c in scene_info.train_cameras
        ]
        self.test_cameras = [
            camera_from_info(c, preload=preload_image, resolution=resolution)
            for c in scene_info.test_cameras
        ]
        self.train_bboxes = scene_info.train_bboxes
        self.test_bboxes = scene_info.test_bboxes
        self.loaded_iter = None
        if load_iteration is None:
            pcd = scene_info.point_cloud
            self.gaussians = gaussians.create_from_points(
                pcd.points, pcd.colors, device=self.device)
        else:
            self.loaded_iter = self._resolve_iteration(load_iteration)
            self.gaussians = load_gaussian_ply(
                Path(self.model_path) / "point_cloud"
                / f"iteration_{self.loaded_iter}" / "point_cloud.ply",
                device=self.device)

    def _resolve_iteration(self, load_iteration: int) -> int:
        if load_iteration != -1:
            return load_iteration
        pc_dir = Path(self.model_path) / "point_cloud"
        iters = [int(p.name.split("_")[-1]) for p in pc_dir.glob("iteration_*")]
        if not iters:
            raise FileNotFoundError(f"no trained iteration under {pc_dir}")
        return max(iters)

    def getTrainCameras(self) -> list[Camera]:
        return self.train_cameras

    def getTestCameras(self) -> list[Camera]:
        return self.test_cameras
