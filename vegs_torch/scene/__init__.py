"""Scene: cameras + the static Gaussian field + one canonical-space field
per dynamic instance (port of vegs_tpu/scene/__init__.py).

Weights-only PLY snapshots in the reference's attribute layout: a PLY
written by the JAX package's `save_gaussian_ply` loads here unchanged, and
the other way round. A Scene reads its dataset by `cfg_model.data_type`
(`kitti360`, `colmap` or `blender`, through `sceneLoadTypeCallbacks`) or
takes a given SceneInfo; its fields are those of a trained iteration
(`save` writes them: the static PLY and one per instance), or seeded: the
static field from the SceneInfo's point cloud (`create_from_points`), each
box field from its instance's points mapped into the canonical box
(`initialize_box_field`).
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
from .dataset_readers import (SceneInfo, camera_from_info,
                              sceneLoadTypeCallbacks)

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


def initialize_box_field(
    dyn_pcd,
    instance_id: int,
    bboxes: dict,
    init_opacity: float = 0.1,
    fallback_points: int = 8196,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> GaussianField:
    """Canonical-space Gaussian field of one dynamic instance.

    Maps each frame's points of the instance into the canonical box with
    world2box = inv(box2world) and keeps those inside |c| <= 0.5 + 1e-3;
    with 16 points or fewer (an untracked instance) it takes
    `fallback_points` uniform points in [-0.5, 0.5]^3 from `rng` (default:
    seed 0) instead. The squared knn distance is clamped to [1e-7, 1e-4].
    `bboxes` is {frame: {instance: box2world [4, 4] (or a record with a
    `box2world`)}}."""
    rng = rng or np.random.default_rng(0)
    pts_all, col_all = [], []
    if dyn_pcd is not None:
        sel = np.asarray(dyn_pcd.instances) == instance_id
        pts = np.asarray(dyn_pcd.points)[sel]
        cols = np.asarray(dyn_pcd.colors)[sel]
        ts = np.asarray(dyn_pcd.timestamps)[sel]
        for frame, inst_boxes in bboxes.items():
            if instance_id not in inst_boxes:
                continue
            frame_sel = ts == frame
            if not frame_sel.any():
                continue
            world2box = np.linalg.inv(box_matrix(inst_boxes[instance_id]))
            p = pts[frame_sel]
            canon = (np.concatenate([p, np.ones((len(p), 1))], 1)
                     @ world2box.T)[:, :3]
            inside = np.all(np.abs(canon) <= 0.5 + 1e-3, axis=1)
            pts_all.append(canon[inside])
            col_all.append(cols[frame_sel][inside])
    if pts_all and sum(len(p) for p in pts_all) > 16:
        points = np.concatenate(pts_all, 0)
        colors = np.concatenate(col_all, 0)
    else:
        points = rng.uniform(-0.5, 0.5, (fallback_points, 3)).astype(np.float32)
        colors = np.full((fallback_points, 3), 0.5, np.float32)
    return gaussians.create_from_points(
        points, colors, init_opacity=init_opacity, scale_clip=(1e-7, 1e-4),
        device=resolve_device(device))


def box_matrix(box) -> np.ndarray:
    """The [4, 4] box-to-world matrix of an annotation: the array itself,
    or a record's `box2world`."""
    return np.asarray(box.box2world if hasattr(box, "box2world") else box)


class Scene:
    """Cameras of a scene, the static field and the box fields
    (`box_gaussians`, {instance: GaussianField}), as the JAX Scene takes
    them: `cfg_model` (config.ModelParams: model_path, source_path,
    data_type, eval, images, white_background, resolution, preload_image),
    `cfg_data` (config.KITTI360DataParams, for kitti360) and `cfg_box`
    (config.BoxModelParams: the box fields' initial opacity, 0.1 without
    it). The dataset is read unless `scene_info` is given.

    With `load_iteration=None` the fields are seeded from the SceneInfo's
    point clouds; otherwise they are those of a trained iteration
    (`model_path/point_cloud/iteration_<i>/point_cloud.ply` and
    `model_path/instance_<id>/point_cloud/iteration_<i>/point_cloud.ply`;
    -1 = the latest). The fields live on `device` (default: the card)."""

    def __init__(
        self,
        cfg_model,
        cfg_data=None,
        cfg_box=None,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        scene_info: Optional[SceneInfo] = None,
        preload_image: Optional[bool] = None,
        device=None,
    ):
        self.model_path = str(cfg_model.model_path)
        self.device = resolve_device(device)
        preload = (cfg_model.preload_image if preload_image is None
                   else preload_image)
        if scene_info is None:
            scene_info = _read_scene(cfg_model, cfg_data, preload)
        self.scene_info = scene_info
        if shuffle:
            random.shuffle(scene_info.train_cameras)
        self.cameras_extent = scene_info.nerf_normalization["radius"]
        res = getattr(cfg_model, "resolution", -1)
        self.train_cameras = [
            camera_from_info(c, preload=preload, resolution=res)
            for c in scene_info.train_cameras
        ]
        self.test_cameras = [
            camera_from_info(c, preload=preload, resolution=res)
            for c in scene_info.test_cameras
        ]
        self.train_bboxes = scene_info.train_bboxes
        self.test_bboxes = scene_info.test_bboxes
        self.instances_info = list(scene_info.instances_info)
        self.loaded_iter = None
        if load_iteration is None:
            pcd = scene_info.point_cloud
            self.gaussians = gaussians.create_from_points(
                pcd.points, pcd.colors, device=self.device)
            init_op = (cfg_box.gaussian_box_model_init_opacity if cfg_box
                       else 0.1)
            # every frame's annotations, train and test (a new dict: the
            # train split's records are left as they are)
            all_bboxes = {f: dict(d) for f, d in self.train_bboxes.items()}
            for f, d in self.test_bboxes.items():
                all_bboxes.setdefault(f, {}).update(d)
            self.box_gaussians = {
                inst: initialize_box_field(
                    scene_info.dyn_point_cloud, inst, all_bboxes,
                    init_opacity=init_op, device=self.device)
                for inst in self.instances_info}
        else:
            self.loaded_iter = self._resolve_iteration(load_iteration)
            self.gaussians = load_gaussian_ply(
                Path(self.model_path) / "point_cloud"
                / f"iteration_{self.loaded_iter}" / "point_cloud.ply",
                device=self.device)
            self.box_gaussians = {}
            for inst in self.instances_info:
                p = self._instance_ply(inst, self.loaded_iter)
                if p.exists():
                    self.box_gaussians[inst] = load_gaussian_ply(
                        p, device=self.device)

    def _resolve_iteration(self, load_iteration: int) -> int:
        if load_iteration != -1:
            return load_iteration
        pc_dir = Path(self.model_path) / "point_cloud"
        iters = [int(p.name.split("_")[-1]) for p in pc_dir.glob("iteration_*")]
        if not iters:
            raise FileNotFoundError(f"no trained iteration under {pc_dir}")
        return max(iters)

    def _instance_ply(self, inst, iteration: int) -> Path:
        return (Path(self.model_path) / f"instance_{inst}" / "point_cloud"
                / f"iteration_{iteration}" / "point_cloud.ply")

    def save(self, iteration: int) -> None:
        """Write the static field's PLY and one PLY per box instance."""
        save_gaussian_ply(Path(self.model_path) / "point_cloud"
                          / f"iteration_{iteration}" / "point_cloud.ply",
                          self.gaussians)
        for inst, field in self.box_gaussians.items():
            save_gaussian_ply(self._instance_ply(inst, iteration), field)

    def getTrainCameras(self) -> list[Camera]:
        return self.train_cameras

    def getTestCameras(self) -> list[Camera]:
        return self.test_cameras


def _read_scene(cfg_model, cfg_data, preload: bool) -> SceneInfo:
    """The SceneInfo of `cfg_model.data_type`'s reader."""
    dt = cfg_model.data_type
    if dt == "kitti360":
        return sceneLoadTypeCallbacks["KITTI360"](
            cfg_model.source_path, eval=cfg_model.eval, seq=cfg_data.seq,
            start_frame=cfg_data.start_frame, end_frame=cfg_data.end_frame,
            preload_image=preload, exclude_lidar=cfg_data.exclude_lidar,
            exclude_colmap=cfg_data.exclude_colmap,
            colmap_data_type=cfg_data.colmap_data_type,
            cache_dir=cfg_model.cache_dir)
    if dt == "colmap":
        return sceneLoadTypeCallbacks["Colmap"](
            cfg_model.source_path, cfg_model.images, cfg_model.eval)
    if dt == "blender":
        return sceneLoadTypeCallbacks["Blender"](
            cfg_model.source_path, cfg_model.white_background, cfg_model.eval)
    raise ValueError(f"unknown data_type {dt}")
