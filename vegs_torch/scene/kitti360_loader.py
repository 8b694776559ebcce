"""Minimal KITTI-360 dataset parsing: poses, calibration, 3D boxes (port of
vegs_tpu/scene/kitti360_loader.py, numpy only).

Self-contained replacement for the `kitti360scripts` package the reference
depends on: perspective camera poses/intrinsics (project.CameraPerspective)
and 3D bounding-box annotations (annotation.Annotation3D), implemented
directly from the KITTI-360 on-disk formats:

  calibration/perspective.txt        P_rect_xx / R_rect_xx / S_rect_xx rows
  calibration/calib_cam_to_pose.txt  image_xx: 3x4 cam->IMU transforms
  data_poses/{seq}/poses.txt         frame + 3x4 IMU->world rows
  data_3d_bboxes/train_full/{seq}.xml      OpenCV-storage XML of box transforms

cam2world(frame) = pose(frame) @ camToPose @ inv(R_rect)  — the box transform
matrices keep their scale (the annotation maps the canonical unit cube
[-0.5, 0.5]^3 into the world), which is exactly what the dynamic-object
Gaussian models need (reference scene/gaussian_model.py:485-492).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


def _parse_matrix_text(text: str, rows: int, cols: int) -> np.ndarray:
    vals = [float(v) for v in text.split()]
    return np.array(vals, dtype=np.float64).reshape(rows, cols)


def load_perspective_calib(calib_dir: str) -> dict:
    """Parse calibration/perspective.txt into {key: array} with P_rect_xx
    [3,4], R_rect_xx [3,3], S_rect_xx [2]."""
    out = {}
    path = os.path.join(calib_dir, "perspective.txt")
    for line in open(path):
        if ":" not in line:
            continue
        key, value = line.split(":", 1)
        key = key.strip()
        vals = np.array([float(v) for v in value.split()])
        if key.startswith("P_rect"):
            out[key] = vals.reshape(3, 4)
        elif key.startswith("R_rect"):
            out[key] = vals.reshape(3, 3)
        else:
            out[key] = vals
    return out


def load_cam_to_pose(calib_dir: str) -> dict[str, np.ndarray]:
    """calibration/calib_cam_to_pose.txt -> {image_00: [4,4], ...}."""
    out = {}
    path = os.path.join(calib_dir, "calib_cam_to_pose.txt")
    for line in open(path):
        if ":" not in line:
            continue
        key, value = line.split(":", 1)
        m = np.eye(4)
        m[:3] = _parse_matrix_text(value, 3, 4)
        out[key.strip()] = m
    return out


def load_poses(pose_file: str) -> dict[int, np.ndarray]:
    """data_poses/{seq}/poses.txt -> {frame: [4,4] IMU->world}."""
    out = {}
    for line in open(pose_file):
        vals = line.split()
        if not vals:
            continue
        frame = int(float(vals[0]))
        m = np.eye(4)
        body = np.array([float(v) for v in vals[1:]])
        if body.size == 12:
            m[:3] = body.reshape(3, 4)
        elif body.size == 16:
            m = body.reshape(4, 4)
        out[frame] = m
    return out


@dataclass
class CameraPerspective:
    """Per-camera rectified intrinsics + per-frame cam->world poses
    (parity with kitti360scripts.helpers.project.CameraPerspective)."""

    root_dir: str
    seq: str
    cam_id: int = 0
    K: np.ndarray = field(init=False)          # [3, 3]
    width: int = field(init=False)
    height: int = field(init=False)
    cam2world: dict[int, np.ndarray] = field(init=False)
    frames: np.ndarray = field(init=False)

    def __post_init__(self):
        calib_dir = os.path.join(self.root_dir, "calibration")
        persp = load_perspective_calib(calib_dir)
        cam = f"{self.cam_id:02d}"
        P = persp[f"P_rect_{cam}"]
        self.K = P[:3, :3].copy()
        S = persp.get(f"S_rect_{cam}")
        self.width = int(S[0]) if S is not None else 1408
        self.height = int(S[1]) if S is not None else 376

        R_rect = np.eye(4)
        R_rect[:3, :3] = persp[f"R_rect_{cam}"]
        cam_to_pose = load_cam_to_pose(calib_dir)[f"image_{cam}"]

        pose_file = os.path.join(self.root_dir, "data_poses", self.seq, "poses.txt")
        poses = load_poses(pose_file)
        self.cam2world = {
            f: p @ cam_to_pose @ np.linalg.inv(R_rect) for f, p in poses.items()
        }
        self.frames = np.array(sorted(self.cam2world.keys()))


# ---------------------------------------------------------------------------
# 3D bounding boxes
# ---------------------------------------------------------------------------

# KITTI-360 semantic ids for vehicle classes (car..caravan), the set the
# reference models as dynamic objects (dataset_readers.py:603, obj_sem_ids).
VEHICLE_SEMANTIC_IDS = (26, 27, 28, 29, 30)


@dataclass
class Bbox3D:
    """One annotated box at one timestamp. `R` includes the box scale: it maps
    the canonical unit cube [-0.5, 0.5]^3 into the world."""

    global_id: int
    semantic_id: int
    instance_id: int
    timestamp: int
    label: str
    R: np.ndarray  # [3, 3] rotation*scale
    T: np.ndarray  # [3]
    vertices: np.ndarray | None = None

    @property
    def box2world(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R
        m[:3, 3] = self.T
        return m


def local2global(semantic_id: int, instance_id: int) -> int:
    return int(semantic_id) * 1000 + int(instance_id)


def _child_text(node, name, default=None):
    c = node.find(name)
    return c.text if c is not None and c.text is not None else default


def load_annotations_3d(label_dir: str, seq: str) -> dict[int, dict[int, Bbox3D]]:
    """Parse data_3d_bboxes XML -> {global_id: {timestamp: Bbox3D}}.

    Accepts either {label_dir}/train/{seq}.xml or {label_dir}/train_full/{seq}.xml.
    """
    candidates = [
        os.path.join(label_dir, "train_full", f"{seq}.xml"),
        os.path.join(label_dir, "train", f"{seq}.xml"),
        os.path.join(label_dir, f"{seq}.xml"),
    ]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(f"no 3D bbox XML for {seq} under {label_dir}")

    tree = ET.parse(path)
    root = tree.getroot()
    objects: dict[int, dict[int, Bbox3D]] = {}
    for node in root:
        transform_node = node.find("transform")
        if transform_node is None or node.find("semanticId") is None:
            continue
        rows = int(_child_text(transform_node, "rows", 4))
        cols = int(_child_text(transform_node, "cols", 4))
        m = _parse_matrix_text(_child_text(transform_node, "data"), rows, cols)
        transform = np.eye(4)
        transform[:rows, :cols] = m

        sem = int(_child_text(node, "semanticId", -1))
        inst = int(_child_text(node, "instanceId", -1))
        ts = int(_child_text(node, "timestamp", -1))
        label = _child_text(node, "label", node.tag)

        verts = None
        vn = node.find("vertices")
        if vn is not None and vn.find("data") is not None:
            vr = int(_child_text(vn, "rows", 0))
            vc = int(_child_text(vn, "cols", 3))
            if vr:
                verts = _parse_matrix_text(_child_text(vn, "data"), vr, vc)

        gid = local2global(sem, inst)
        box = Bbox3D(
            global_id=gid, semantic_id=sem, instance_id=inst, timestamp=ts,
            label=label, R=transform[:3, :3], T=transform[:3, 3], vertices=verts,
        )
        objects.setdefault(gid, {})[ts] = box
    return objects


def read_kitti360_3d_annotations(
    path: str,
    seq: str,
    start_frame: int | None = None,
    end_frame: int | None = None,
    obj_sem_ids=VEHICLE_SEMANTIC_IDS,
):
    """{timestamp: {global_id: box2world}} + sorted instance-id list
    (parity with readKITTI3603DAnnotations, dataset_readers.py:191-215)."""
    objects = load_annotations_3d(os.path.join(path, "data_3d_bboxes"), seq)
    bboxes: dict[int, dict[int, Bbox3D]] = {}
    inst_info = []
    for gid, per_ts in objects.items():
        timestamps = list(per_ts.keys())
        if start_frame is not None and end_frame is not None:
            timestamps = [
                t for t in timestamps if int(start_frame) <= t < int(end_frame)
            ]  # prunes the static -1 stamp, like the reference
        for ts in timestamps:
            box = per_ts[ts]
            if box.semantic_id not in obj_sem_ids:
                continue
            bboxes.setdefault(ts, {})[gid] = box
            inst_info.append(gid)
    return bboxes, sorted(set(inst_info))
