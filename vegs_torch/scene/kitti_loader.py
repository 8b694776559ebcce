"""KITTI (tracking benchmark) parsing: calibration, oxts/IMU poses, tracklets,
and box geometry helpers.

Port of vegs_tpu/scene/kitti_loader.py (numpy and scipy): calibration
parsing (tracking_calib_from_txt, 156-177), oxts->Mercator IMU poses
(get_poses_calibration, 178-252), stereo camera poses with the per-scene rig
debug offsets (get_camera_poses_tracking, 45-100), tracklet->box2world with
static-object removal by <0.5 m displacement (get_obj_pose_tracking, 253-373),
and the box geometry utilities (boxes_to_corners_3d 450-473, Delaunay
is_within_3d_box 496-516, points_to_canonical 518-540).
"""

from __future__ import annotations

import os

import numpy as np

CAMERA_LS = [2, 3]  # stereo RGB cameras

SEM2LABEL = {
    "Misc": -1,
    "Car": 0,
    "Van": 0,
    "Truck": 2,
    "Tram": 3,
    "Pedestrian": 4,
}


def get_rotation(roll, pitch, heading):
    """ZYX euler composition (reference kitti_loader.py:21-36)."""
    sz, cz = np.sin(heading), np.cos(heading)
    sy, cy = np.sin(pitch), np.cos(pitch)
    sx, cx = np.sin(roll), np.cos(roll)
    rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rot_z @ rot_y @ rot_x


def invert_transformation(rot, t):
    t_inv = -rot.T @ t
    top = np.concatenate([rot.T, t_inv[:, None]], axis=1)
    return np.concatenate([top, np.array([[0.0, 0.0, 0.0, 1.0]])])


def tracking_calib_from_txt(calibration_path) -> dict:
    """Parse the per-sequence tracking calib file: P0..P3, R_rect,
    Tr_velo_cam, Tr_imu_velo (reference 156-177)."""
    rows = []
    for line in open(calibration_path):
        vals = line.split()[1:]
        if vals:
            rows.append(np.array([float(v) for v in vals]))
    P0, P1, P2, P3 = (r.reshape(3, 4) for r in rows[:4])
    Tr_cam2camrect = np.eye(4)
    Tr_cam2camrect[:3, :3] = rows[4].reshape(3, 3)
    Tr_velo2cam = np.concatenate(
        [rows[5].reshape(3, 4), np.array([[0, 0, 0, 1.0]])], axis=0)
    Tr_imu2velo = np.concatenate(
        [rows[6].reshape(3, 4), np.array([[0, 0, 0, 1.0]])], axis=0)
    return {
        "P0": P0, "P1": P1, "P2": P2, "P3": P3,
        "Tr_cam2camrect": Tr_cam2camrect,
        "Tr_velo2cam": Tr_velo2cam,
        "Tr_imu2velo": Tr_imu2velo,
    }


def latlon_to_mercator(lat, lon, scale):
    r = 6378137.0
    x = scale * r * ((np.pi * lon) / 180)
    y = scale * r * np.log(np.tan((np.pi * (90 + lat)) / 360))
    return x, y


def oxts_to_pose(oxts: np.ndarray) -> np.ndarray:
    """GPS/IMU rows -> [N, 4, 4] IMU->world, first frame at origin."""
    lat0 = oxts[0][0]
    scale = np.cos(lat0 * np.pi / 180)
    poses = []
    pose_0_inv = None
    for row in oxts:
        x, y = latlon_to_mercator(row[0], row[1], scale)
        pose = np.eye(4)
        pose[:3, :3] = get_rotation(row[3], row[4], row[5])
        pose[:3, 3] = [x, y, row[2]]
        if pose_0_inv is None:
            pose_0_inv = invert_transformation(pose[:3, :3], pose[:3, 3])
        poses.append(pose_0_inv @ pose)
    return np.array(poses)


def get_poses_calibration(basedir, oxts_path_tracking):
    """IMU poses from the tracking oxts file (reference 178-252)."""
    oxts = np.loadtxt(oxts_path_tracking)
    return oxts_to_pose(np.atleast_2d(oxts)), None, None


def _rig_debug_angles(scene_no, exp):
    """Per-scene camera-rig correction angles (reference 45-80)."""
    if scene_no == 2:
        return np.deg2rad(0.7), np.deg2rad(-0.5), np.deg2rad(0.9)
    if scene_no == 1:
        if exp:
            return np.deg2rad(0.3), np.deg2rad(-0.6), np.deg2rad(0.75)
        return np.deg2rad(0.5), np.deg2rad(-0.5), np.deg2rad(0.75)
    return np.deg2rad(0.05), np.deg2rad(-0.75), np.deg2rad(1.05)


def get_camera_poses_tracking(poses_velo_w, calib, scene_no=None, exp=False):
    """Stereo cam->world poses [2*N, 4, 4] (cam 2 block then cam 3 block)."""
    yaw, pitch, roll = _rig_debug_angles(scene_no, exp)
    cam_debug = np.eye(4)
    cam_debug[:3, :3] = get_rotation(roll, pitch, yaw)

    Tr_cam2camrect = calib["Tr_cam2camrect"] @ cam_debug
    Tr_camrect2cam = np.linalg.inv(Tr_cam2camrect)
    Tr_cam2velo = np.linalg.inv(calib["Tr_velo2cam"])

    blocks = []
    for cam in CAMERA_LS:
        Tr_camrect2cam_i = calib[f"Tr_camrect2cam0{cam}"]
        cam_i_cam0 = Tr_camrect2cam @ np.linalg.inv(Tr_camrect2cam_i)
        cam_i_velo = Tr_cam2velo @ cam_i_cam0
        blocks.append(poses_velo_w @ cam_i_velo)
    return np.concatenate(blocks, axis=0)


def get_scene_images(basedir, seq):
    imgs = []
    for sub in (f"image_02/{seq}", f"image_03/{seq}"):
        d = os.path.join(basedir, sub)
        imgs += [os.path.join(d, f) for f in sorted(os.listdir(d))]
    return imgs


def roty_matrix(roty):
    c, s = np.cos(roty), np.sin(roty)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def get_obj_pose_tracking(tracklet_path, poses_imu, calib,
                          min_displacement: float = 0.5):
    """Tracklets -> (visible_objects [2N, M, 18], objects_meta,
    visible_objects_box2world [N, M, 4, 4]); near-static objects removed
    (reference 253-373)."""
    velo2cam = calib["Tr_velo2cam"]
    imu2velo = calib["Tr_imu2velo"]
    cam2velo = invert_transformation(velo2cam[:3, :3], velo2cam[:3, 3])
    velo2imu = invert_transformation(imu2velo[:3, :3], imu2velo[:3, 3])

    objects_meta_kitti = {}
    objects_meta = {}
    tracklets = []
    n_frames = len(poses_imu)
    n_obj_in_frame = np.zeros(n_frames)

    for line in open(tracklet_path).read().splitlines():
        t = line.split()
        if not t or float(t[1]) < 0:
            continue
        oid = int(t[1])
        if t[2] not in SEM2LABEL:
            continue
        label = SEM2LABEL[t[2]]
        if oid not in objects_meta_kitti:
            height, width, length = t[10], t[11], t[12]
            objects_meta_kitti[oid] = np.array(
                [float(oid), label, float(length), float(height), float(width)])
        tracklets.append(np.concatenate([
            np.array(t[:2], np.float64), np.array([label]),
            np.array(t[3:], np.float64)]))
        n_obj_in_frame[int(float(t[0]))] += 1

    max_obj = int(n_obj_in_frame.max()) if len(tracklets) else 0
    visible_objects = -np.ones((n_frames * 2, max(max_obj, 1), 18))
    box2world = -np.ones((n_frames, max(max_obj, 1), 4, 4))

    for tr in tracklets:
        frame_no = int(tr[0])
        oid = int(tr[1])
        meta = objects_meta_kitti[oid]
        if oid not in objects_meta:
            objects_meta[oid] = np.concatenate([
                np.array([oid], np.float64), meta[2:], np.array([meta[1]])])
        pose = tr[-4:]  # (x, y, z, rot_y) in camera coords
        obj_pose_c = np.eye(4)
        obj_pose_c[:3, 3] = pose[:3]
        obj_pose_c[:3, :3] = roty_matrix(pose[3])
        obj_pose_imu = velo2imu @ cam2velo @ obj_pose_c
        pose_w = poses_imu[frame_no] @ obj_pose_imu
        yaw_approx = -np.arctan2(pose_w[1, 0], pose_w[0, 0])
        pose_3d = np.array([pose_w[0, 3], pose_w[1, 3], pose_w[2, 3],
                            yaw_approx, 0, 0, 1.0])

        for j, cam in enumerate(CAMERA_LS):
            row = np.concatenate([
                [frame_no], [float(cam)], [oid], [meta[1]], meta[-3:],
                pose_3d, pose])
            fc = frame_no + j * n_frames
            col = int(np.argwhere(visible_objects[fc, :, 0] < 0).min())
            visible_objects[fc, col] = row
            if j == 0:
                box2world[frame_no, col] = pose_w

    # Remove (near-)static objects by displacement between first/last sighting.
    for oid in list(objects_meta.keys()):
        where = np.where(visible_objects[:, :, 2] == oid)
        if len(where[0]) == 0 or objects_meta[oid][4] == 4.0:  # keep pedestrians
            continue
        fi = where[0][[0, -1]]
        yi = where[1][[0, -1]]
        p = visible_objects[fi, yi][:, 7:10]
        if np.linalg.norm(p[1] - p[0]) < min_displacement:
            visible_objects[where] = -1.0
            del objects_meta[oid]

    return visible_objects, objects_meta, box2world


# ---------------------------------------------------------------------------
# Box geometry helpers
# ---------------------------------------------------------------------------


def cart_to_hom(pts: np.ndarray) -> np.ndarray:
    return np.hstack([pts, np.ones((pts.shape[0], 1), np.float32)])


def rotate_points_along_z(points, angle):
    """points [B, N, 3], angle [B] -> rotated (reference 475-494)."""
    c, s = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack([c, s, zeros, -s, c, zeros, zeros, zeros, ones],
                   axis=1).reshape(-1, 3, 3)
    return points @ rot


def boxes_to_corners_3d(boxes3d: np.ndarray) -> np.ndarray:
    """[N, 7] (center, dims, heading) -> [N, 8, 3] corners (reference 450-473)."""
    template = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ]) / 2.0
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6]).reshape(-1, 8, 3)
    return corners + boxes3d[:, None, 0:3]


def is_within_3d_box(points: np.ndarray, corners3d: np.ndarray):
    """[N,3] x [M,8,3] -> [M,N] bool via Delaunay hulls (reference 496-516)."""
    from scipy.spatial import Delaunay

    flags = []
    for corners in corners3d:
        hull = Delaunay(corners)
        flags.append(hull.find_simplex(points) >= 0)
    return np.stack(flags, axis=0) if flags else None


def points_to_canonical(points: np.ndarray, box: np.ndarray):
    """Map in-box points to centered, yaw-aligned, max-dim-normalized frame
    (reference 518-540)."""
    center = box[:3].reshape(1, 3)
    rot = -box[-1:].reshape(1)
    centered = (points - center).reshape(1, -1, 3)
    rotated = rotate_points_along_z(centered, rot)
    scale = (1.0 / np.abs(box[3:6]).max()) * 0.999999
    box_canonical = box.copy()
    box_canonical[:3] = 0
    box_canonical[-1] = 0
    return rotated.squeeze(0) * scale, box_canonical * scale


def box2world_from_tracking(box_row: np.ndarray, pose_w: np.ndarray) -> np.ndarray:
    """Compose a canonical-cube box2world (rotation*dims + center) from a
    tracking row's dims and its world pose."""
    dims = box_row[4:7]  # length, height, width
    m = np.array(pose_w)
    m[:3, :3] = m[:3, :3] @ np.diag(dims)
    return m
