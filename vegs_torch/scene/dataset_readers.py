"""Scene/dataset readers: KITTI-360, KITTI tracking, COLMAP and
Blender-synthetic scenes (port of vegs_tpu/scene/dataset_readers.py; host
side, numpy only).

The records (static point cloud; the dynamic instances' points with their
instance id and frame; CameraInfo, SceneInfo), the FoV helpers, the nerf++
normalization, PLY fetch and store, the four scene readers dispatched by
`sceneLoadTypeCallbacks`, the random virtual rig (`generateRandomCameras`)
and `camera_from_info`. Images and their sizes are read with PIL,
imported where a reader opens a file, as in the JAX readers.

The KITTI-360 and KITTI readers write the fused static cloud to
`<ply_cache_dir>/points3d_<segment>.ply`, relative to the working
directory (default `.cache`), as the JAX readers do.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from .. import geometry
from ..sh import sh_to_rgb
from . import colmap_loader, kitti360_loader, ply_io
from .cameras import Camera, _load_image, _load_normal, resolve_resolution


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: Optional[np.ndarray] = None


class DynamicPointCloud(NamedTuple):
    """Points of the dynamic instances in WORLD space, each with its
    instance id and the frame it was captured in."""

    points: np.ndarray
    colors: np.ndarray
    instances: np.ndarray
    timestamps: np.ndarray


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
    dyn_point_cloud: Optional[DynamicPointCloud] = None
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


# ---------------------------------------------------------------------------
# PLY fetch / store
# ---------------------------------------------------------------------------


def fetchPly(path, return_normals=True) -> BasicPointCloud:
    v = ply_io.read_ply(path)["vertex"]
    positions = np.vstack([v["x"], v["y"], v["z"]]).T
    colors = np.vstack([v["red"], v["green"], v["blue"]]).T / 255.0
    normals = None
    if return_normals and "nx" in (v.dtype.names or ()):
        normals = np.vstack([v["nx"], v["ny"], v["nz"]]).T
    return BasicPointCloud(points=positions, colors=colors, normals=normals)


def fetchPlyKITTI360(path, visible_only=True, exclude_lidar=False,
                     exclude_colmap=True, colmap_data_type="") -> BasicPointCloud:
    """LiDAR static points (visible==1) and the COLMAP-triangulated
    points of the same segment."""
    all_pos, all_col = [], []
    if not exclude_lidar:
        v = ply_io.read_ply(path)["vertex"]
        positions = np.vstack([v["x"], v["y"], v["z"]]).T
        colors = np.vstack([v["red"], v["green"], v["blue"]]).T / 255.0
        if visible_only and "visible" in (v.dtype.names or ()):
            mask = v["visible"] == 1
            positions, colors = positions[mask], colors[mask]
        all_pos.append(positions)
        all_col.append(colors)
    if not exclude_colmap:
        colmap_path = path.replace(
            "data_3d_semantics", f"data_3d_colmap{colmap_data_type}"
        ).replace(".ply", "")
        colmap_ply = os.path.join(colmap_path, "points3D.ply")
        assert os.path.exists(colmap_ply), "Colmap ply file not found!"
        pcd = fetchPly(colmap_ply, return_normals=False)
        all_pos.append(pcd.points)
        all_col.append(pcd.colors)
    return BasicPointCloud(
        points=np.concatenate(all_pos, 0).astype(np.float32),
        colors=np.concatenate(all_col, 0),
    )


def fetchDynamicPlyKITTI360(path, semantic_ids=(26,), visible_only=True) -> DynamicPointCloud:
    """Per-point (instance, timestamp) dynamic cloud."""
    v = ply_io.read_ply(path)["vertex"]
    positions = np.vstack([v["x"], v["y"], v["z"]]).T
    colors = np.vstack([v["red"], v["green"], v["blue"]]).T / 255.0
    instances = np.asarray(v["instance"])
    timestamps = np.asarray(v["timestamp"])
    if visible_only:
        sem_mask = np.isin(np.asarray(v["semantic"]), np.asarray(semantic_ids))
        mask = sem_mask & (np.asarray(v["visible"]) == 1)
        positions, colors = positions[mask], colors[mask]
        instances, timestamps = instances[mask], timestamps[mask]
    return DynamicPointCloud(positions, colors, instances, timestamps)


def storePly(path, xyz, rgb):
    vertex = ply_io.make_vertex_array({
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
        "red": np.asarray(rgb[:, 0], np.uint8),
        "green": np.asarray(rgb[:, 1], np.uint8),
        "blue": np.asarray(rgb[:, 2], np.uint8),
    })
    ply_io.write_ply(path, vertex)


def storeDynamicPly(path, xyz, rgb, instance, timestamp):
    vertex = ply_io.make_vertex_array({
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
        "red": np.asarray(rgb[:, 0], np.uint8),
        "green": np.asarray(rgb[:, 1], np.uint8),
        "blue": np.asarray(rgb[:, 2], np.uint8),
        "instance": np.asarray(instance, np.int32),
        "timestamp": np.asarray(timestamp, np.int32),
    })
    ply_io.write_ply(path, vertex)


# ---------------------------------------------------------------------------
# COLMAP scenes
# ---------------------------------------------------------------------------


def readColmapCameras(cam_extrinsics, cam_intrinsics, images_folder) -> list[CameraInfo]:
    infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        R = colmap_loader.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
            cx, cy = intr.params[1], intr.params[2]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
            cx, cy = intr.params[2], intr.params[3]
        else:
            raise ValueError(
                "Colmap camera model not handled: only PINHOLE/SIMPLE_PINHOLE"
            )
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T,
            FovY=focal2fov(fy, intr.height), FovX=focal2fov(fx, intr.width),
            image=None, image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=intr.width, height=intr.height, K=K,
        ))
    return sorted(infos, key=lambda c: c.image_name)


def readColmapSceneInfo(path, images=None, eval=False, llffhold=8) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap_loader.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap_loader.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap_loader.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap_loader.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = "images" if images is None else images
    cam_infos = readColmapCameras(extr, intr, os.path.join(path, reading_dir))
    if eval:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap_loader.read_points3D_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap_loader.read_points3D_text(
                os.path.join(sparse, "points3D.txt"))
        storePly(ply_path, xyz, rgb)
    pcd = fetchPly(ply_path)

    return SceneInfo(
        point_cloud=pcd, train_cameras=train, test_cameras=test,
        nerf_normalization=getNerfppNorm(train), ply_path=ply_path,
    )


# ---------------------------------------------------------------------------
# Blender-synthetic scenes
# ---------------------------------------------------------------------------


def readCamerasFromTransforms(path, transformsfile, white_background,
                              extension=".png") -> list[CameraInfo]:
    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        from PIL import Image

        image = np.asarray(Image.open(cam_name).convert("RGBA"),
                           np.float32) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        rgb = image[..., :3] * image[..., 3:] + bg * (1 - image[..., 3:])
        w, h = rgb.shape[1], rgb.shape[0]
        fovy = focal2fov(fov2focal(fovx, w), h)
        K = np.array([
            [fov2focal(fovx, w), 0, w / 2], [0, fov2focal(fovy, h), h / 2], [0, 0, 1]
        ])
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx,
            image=rgb.transpose(2, 0, 1).astype(np.float32),
            image_path=cam_name, image_name=Path(cam_name).stem,
            width=w, height=h, K=K,
        ))
    return infos


def readNerfSyntheticInfo(path, white_background=False, eval=False,
                          extension=".png") -> SceneInfo:
    train = readCamerasFromTransforms(path, "transforms_train.json",
                                      white_background, extension)
    test = readCamerasFromTransforms(path, "transforms_test.json",
                                     white_background, extension)
    if not eval:
        train = train + test
        test = []
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        storePly(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    pcd = fetchPly(ply_path)
    return SceneInfo(
        point_cloud=pcd, train_cameras=train, test_cameras=test,
        nerf_normalization=getNerfppNorm(train), ply_path=ply_path,
    )


# ---------------------------------------------------------------------------
# KITTI-360 scenes
# ---------------------------------------------------------------------------


def readKITTI360Cameras(path, seq, start_frame=None, end_frame=None,
                        preload_image=False, cache_dir="") -> list[CameraInfo]:
    """Stereo perspective cameras over a frame range."""
    cams = [kitti360_loader.CameraPerspective(path, seq, cam_id=i) for i in (0, 1)]
    assert np.all(cams[0].frames == cams[1].frames), "stereo frame mismatch"
    frames = sorted(cams[0].frames.tolist())
    frames = [
        f for f in frames
        if (start_frame is None or f >= int(start_frame))
        and (end_frame is None or f < int(end_frame))
    ]

    infos = []
    uid = 0
    for frame in frames:
        for cam_idx in (0, 1):
            cam = cams[cam_idx]
            w2c = np.linalg.inv(cam.cam2world[frame])
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            K = cam.K
            image_name = f"{int(frame):010d}.png"
            image_path = os.path.join(
                path, "data_2d_raw", seq, f"image_{cam_idx:02d}",
                "data_rect", image_name,
            )
            normal_path = os.path.join(
                path, "data_2d_normal_omnidata_all", seq,
                f"image_{cam_idx:02d}", image_name.split(".")[0] + "_norm.npy",
            )
            image = normal = None
            if preload_image:
                image = _load_image(image_path)
                normal = _load_normal(normal_path, (cam.width, cam.height))
            infos.append(CameraInfo(
                uid=uid, R=R, T=T,
                FovY=focal2fov(K[1, 1], cam.height),
                FovX=focal2fov(K[0, 0], cam.width),
                image=image, image_path=image_path, image_name=image_name,
                normal=normal, normal_path=normal_path,
                width=cam.width, height=cam.height, K=K,
                frame=int(frame), cam_idx=cam_idx,
            ))
            uid += 1
    return infos


def readKITTI360SceneInfo(path, eval=True, seq="2013_05_28_drive_0009_sync",
                          start_frame=None, end_frame=None, visible_only=True,
                          llffhold=8, preload_image=False, exclude_lidar=False,
                          exclude_colmap=False, colmap_data_type="",
                          cache_dir="", ply_cache_dir=".cache") -> SceneInfo:
    """Full KITTI-360 segment."""
    seg = f"{int(start_frame):010d}_{int(end_frame):010d}"
    pcd_file = os.path.join(path, "data_3d_semantics", "train", seq, "static",
                            f"{seg}.ply")
    pcd = fetchPlyKITTI360(pcd_file, visible_only=visible_only,
                           exclude_lidar=exclude_lidar,
                           exclude_colmap=exclude_colmap,
                           colmap_data_type=colmap_data_type)
    dyn_file = os.path.join(path, "data_3d_semantics", "train", seq, "dynamic",
                            f"{seg}.ply")
    dyn_pcd = fetchDynamicPlyKITTI360(dyn_file)

    cam_infos = readKITTI360Cameras(path, seq, start_frame, end_frame,
                                    preload_image=preload_image,
                                    cache_dir=cache_dir)
    bboxes, instances_info = kitti360_loader.read_kitti360_3d_annotations(
        path, seq, start_frame, end_frame,
    )
    if eval:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    pick = lambda keys, d: {k: d[k] for k in keys if k in d}
    train_bboxes = pick([int(c.frame) for c in train], bboxes)
    test_bboxes = pick([int(c.frame) for c in test], bboxes)

    os.makedirs(ply_cache_dir, exist_ok=True)
    ply_path = os.path.join(ply_cache_dir, f"points3d_{seg}.ply")
    if not os.path.exists(ply_path):
        storePly(ply_path, pcd.points, np.uint8(pcd.colors * 255))

    return SceneInfo(
        point_cloud=pcd, dyn_point_cloud=dyn_pcd,
        train_cameras=train, test_cameras=test,
        nerf_normalization=getNerfppNorm(cam_infos, pcd),
        ply_path=ply_path,
        train_bboxes=train_bboxes, test_bboxes=test_bboxes,
        instances_info=instances_info,
    )


# ---------------------------------------------------------------------------
# KITTI (tracking benchmark) scenes
# ---------------------------------------------------------------------------


def readKITTICameras(path, seq, preload_image=False) -> list[CameraInfo]:
    """Stereo tracking cameras."""
    from . import kitti_loader as kl

    basedir = os.path.join(path, "training")
    calib = kl.tracking_calib_from_txt(os.path.join(basedir, "calib", seq + ".txt"))
    poses_imu, _, _ = kl.get_poses_calibration(
        basedir, os.path.join(basedir, "oxts", seq + ".txt"))

    imu2velo = calib["Tr_imu2velo"]
    velo2imu = kl.invert_transformation(imu2velo[:3, :3], imu2velo[:3, 3])
    poses_velo = np.matmul(poses_imu, velo2imu)

    for cam_i in (2, 3):
        projection = calib[f"P{cam_i}"]
        K_inv = np.linalg.inv(projection[:3, :3])
        transformation = np.eye(4)
        transformation[:3, 3] = K_inv @ projection[:3, 3]
        calib[f"Tr_camrect2cam0{cam_i}"] = transformation
        calib[f"K{cam_i}"] = projection[:3, :3]

    cam_poses = kl.get_camera_poses_tracking(poses_velo, calib)
    image_paths = sorted(kl.get_scene_images(basedir, seq))
    infos = []
    for uid, image_path in enumerate(image_paths):
        cam_idx = int(image_path.split(os.sep)[-3].split("_")[-1])
        frame = int(os.path.basename(image_path).split(".")[0])
        w2c = np.linalg.inv(cam_poses[uid])
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        K = calib[f"K{cam_idx}"]
        from PIL import Image

        with Image.open(image_path) as im:
            w, h = im.size
        normal_path = image_path.replace("image_", "normal_").replace(
            ".png", "_norm.npy")
        infos.append(CameraInfo(
            uid=uid, R=R, T=T,
            FovY=focal2fov(K[1, 1], h), FovX=focal2fov(K[0, 0], w),
            image=None, image_path=image_path,
            image_name=os.path.basename(image_path),
            normal_path=normal_path, width=w, height=h, K=K,
            frame=frame, cam_idx=cam_idx,
        ))
    return infos


def readKITTI3DAnnotations(path, seq):
    """Tracking tracklets -> {frame: {instance: box2world}} for vehicle
    classes."""
    from . import kitti_loader as kl

    basedir = os.path.join(path, "training")
    calib = kl.tracking_calib_from_txt(os.path.join(basedir, "calib", seq + ".txt"))
    poses_imu, _, _ = kl.get_poses_calibration(
        basedir, os.path.join(basedir, "oxts", seq + ".txt"))
    visible_objects, _, box2worlds = kl.get_obj_pose_tracking(
        os.path.join(basedir, "label_02", seq + ".txt"), poses_imu, calib)

    class _Box:
        def __init__(self, m):
            self.box2world = m

    bboxes = {}
    inst_info = []
    for ts in range(box2worlds.shape[0]):
        for j in range(box2worlds.shape[1]):
            if np.all(box2worlds[ts, j] == -1.0):
                continue
            row = visible_objects[ts, j]
            inst_id = int(row[2])
            obj_type = row[3]
            if obj_type in (0.0, 2.0):  # car/van, truck
                m = kl.box2world_from_tracking(row, box2worlds[ts, j])
                bboxes.setdefault(ts, {})[inst_id] = _Box(m)
                inst_info.append(inst_id)
    return bboxes, sorted(set(inst_info))


def readKITTISceneInfo(path, seq, eval=True, llffhold=8,
                       ply_cache_dir=".cache") -> SceneInfo:
    """KITTI tracking segment."""
    pcd = fetchPlyKITTI360(
        os.path.join(path, "training", "3d_semantics", "static", f"{seq}.ply"),
        visible_only=False)
    dyn_pcd = fetchDynamicPlyKITTI360(
        os.path.join(path, "training", "3d_semantics", "dynamic", f"{seq}.ply"),
        semantic_ids=(0, 2))
    cam_infos = readKITTICameras(path, seq)
    bboxes, instances_info = readKITTI3DAnnotations(path, seq)

    if eval:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    pick = lambda keys, d: {k: d[k] for k in keys if k in d}
    train_bboxes = pick([int(c.frame) for c in train], bboxes)
    test_bboxes = pick([int(c.frame) for c in test], bboxes)

    os.makedirs(ply_cache_dir, exist_ok=True)
    ply_path = os.path.join(ply_cache_dir, f"points3d_{seq}.ply")
    if not os.path.exists(ply_path):
        storePly(ply_path, pcd.points, np.uint8(pcd.colors * 255))

    return SceneInfo(
        point_cloud=pcd, dyn_point_cloud=dyn_pcd,
        train_cameras=train, test_cameras=test,
        nerf_normalization=getNerfppNorm(cam_infos, pcd),
        ply_path=ply_path, train_bboxes=train_bboxes, test_bboxes=test_bboxes,
        instances_info=instances_info,
    )


# ---------------------------------------------------------------------------
# Random virtual rig
# ---------------------------------------------------------------------------


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
    policy (intrinsics scale with the image; FoV does not). With `preload`
    an image not held yet is read from disk at the camera's size. Resizing
    a held image or normal map needs OpenCV, imported only then."""
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
        image = _load_image(info.image_path, (tw, th))
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


sceneLoadTypeCallbacks = {
    "Colmap": readColmapSceneInfo,
    "Blender": readNerfSyntheticInfo,
    "KITTI360": readKITTI360SceneInfo,
    "KITTI": readKITTISceneInfo,
}
