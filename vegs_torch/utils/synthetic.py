"""Synthetic street scenes (numpy copy of vegs_tpu/utils/synthetic.py): a
camera arc, a seeded point sampling of the scene, a tiny ray tracer for
ground-truth images and normal maps, the moving "vehicle" box of the
dynamic-object oracle, and a smooth synthetic normal map. Beside them, a
writer of a KITTI-360 directory in the on-disk layout the readers take
(`write_kitti360_segment`), for tests and smoke runs that need a dataset.

The ray tracer shares no code or representation with the Gaussian
rasterizer: a checkerboard ground plane, lambertian boxes and a sky
gradient, so a PSNR against its images cannot be gamed by the model
reproducing itself.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..scene import ply_io
from ..scene.dataset_readers import CameraInfo, fov2focal, storePly

SUN = np.array([0.45, 0.8, 0.35])
SKY_TOP = np.array([0.45, 0.62, 0.90])
SKY_BOT = np.array([0.80, 0.86, 0.95])
CHECKER_A = np.array([0.72, 0.70, 0.68])
CHECKER_B = np.array([0.35, 0.34, 0.33])

# (center xz, size xyz, albedo) — "buildings"/"vehicles" along a street
BOXES = [
    ((-3.0, 0.0, 8.0), (2.0, 3.0, 2.0), (0.75, 0.30, 0.25)),
    ((3.2, 0.0, 11.0), (2.4, 4.0, 2.4), (0.30, 0.45, 0.75)),
    ((-2.2, 0.0, 15.0), (2.0, 2.2, 3.0), (0.35, 0.65, 0.35)),
    ((0.8, 0.0, 6.0), (1.2, 1.0, 1.6), (0.78, 0.72, 0.30)),
]


def _sun():
    return SUN / np.linalg.norm(SUN)


def _shade(albedo, normal):
    lam = np.clip(normal @ _sun(), 0.0, 1.0)
    return albedo * np.expand_dims(0.35 + 0.65 * lam, -1) \
        if np.ndim(lam) else albedo * (0.35 + 0.65 * lam)


def _box_bounds(box):
    (cx, cy, cz), (sx, sy, sz), _ = box
    lo = np.array([cx - sx / 2, cy, cz - sz / 2])
    hi = np.array([cx + sx / 2, cy + sy, cz + sz / 2])
    return lo, hi


def raytrace(R: np.ndarray, t: np.ndarray, H: int, W: int,
             fovx: float, fovy: float, extra_boxes=(),
             return_normal: bool = False):
    """Render [3, H, W] in [0,1]. `R`/`t` follow the repo's camera
    convention (R = transposed world-to-camera rotation, t = w2c
    translation), as `Camera` takes them.

    `extra_boxes` appends per-frame boxes (same (center_xz, size, albedo)
    tuples as BOXES) — the moving "vehicle" of the dynamic-object oracle.
    `return_normal=True` additionally returns a CAMERA-space per-pixel
    normal map [3, H, W] (the synthetic stand-in for the omnidata prior;
    Camera.world_normal() rotates it back to world). Sky pixels get the
    world up normal, like a monocular estimator would hallucinate."""
    # camera center and axes in world space
    Rwc = R.T                       # world->cam rotation
    C = -Rwc.T @ t                  # camera center
    # pixel ray directions in camera space
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = (np.arange(H) + 0.5) / H * 2 - 1
    dx = xs * np.tan(fovx / 2)
    dy = ys * np.tan(fovy / 2)
    dirs_cam = np.stack(
        [np.broadcast_to(dx[None, :], (H, W)),
         np.broadcast_to(dy[:, None], (H, W)),
         np.ones((H, W))], axis=-1)
    dirs = dirs_cam @ Rwc           # rotate to world (row-vector form)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    tmin = np.full((H, W), np.inf)
    color = np.zeros((H, W, 3))
    # world-space per-pixel normal (y is DOWN: up = -y); sky defaults to up
    nmap = np.broadcast_to(
        np.array([0.0, -1.0, 0.0]), (H, W, 3)).copy()
    # sky background
    up = np.clip(dirs[..., 1], -1, 1)
    sky_t = np.clip(-up, 0.0, 1.0) ** 0.7
    color[:] = SKY_BOT[None, None] * (1 - sky_t[..., None]) \
        + SKY_TOP[None, None] * sky_t[..., None]

    # ground plane at world y = 1.5 (y points DOWN: the plane lies 1.5
    # below the cameras' height)
    plane_y = 1.5
    denom = dirs[..., 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_pl = (plane_y - C[1]) / denom
    hit = (t_pl > 0.1) & (np.abs(denom) > 1e-6)
    p = C[None, None] + dirs * t_pl[..., None]
    checker = ((np.floor(p[..., 0]) + np.floor(p[..., 2])) % 2) == 0
    base = np.where(checker[..., None], CHECKER_A, CHECKER_B)
    fog = np.clip(t_pl / 60.0, 0, 1)[..., None]
    ground_col = _shade(base, np.array([0, -1.0, 0]))
    ground_col = ground_col * (1 - fog) + color * fog
    sel = hit & (t_pl < tmin)
    tmin = np.where(sel, t_pl, tmin)
    color = np.where(sel[..., None], ground_col, color)
    # ground normal already equals the sky default ([0,-1,0])

    # boxes (AABB slab test); box "ground" sits at plane_y going UP (−y)
    for box in list(BOXES) + list(extra_boxes):
        lo, hi = _box_bounds(box)
        lo = lo.copy(); hi = hi.copy()
        # convert box heights to this convention: base at plane_y, top above
        base_y = plane_y
        height = hi[1] - lo[1]
        lo[1], hi[1] = base_y - height, base_y
        albedo = np.array(box[2])
        inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
        t0 = (lo[None, None] - C[None, None]) * inv
        t1 = (hi[None, None] - C[None, None]) * inv
        tn = np.minimum(t0, t1).max(axis=-1)
        tf = np.maximum(t0, t1).min(axis=-1)
        hit = (tn < tf) & (tf > 0.1) & (tn > 0.1)
        # face normal: axis of the entering slab
        enter = np.minimum(t0, t1)
        axis = np.argmax(enter, axis=-1)
        sign = -np.sign(np.take_along_axis(dirs, axis[..., None], -1))[..., 0]
        normal = np.zeros((H, W, 3))
        np.put_along_axis(normal, axis[..., None], sign[..., None], -1)
        col = _shade(albedo[None, None], normal)
        sel = hit & (tn < tmin)
        tmin = np.where(sel, tn, tmin)
        color = np.where(sel[..., None], col, color)
        nmap = np.where(sel[..., None], normal, nmap)

    rgb = np.clip(color.transpose(2, 0, 1), 0.0, 1.0).astype(np.float32)
    if not return_normal:
        return rgb
    # world -> camera: n_cam = R_w2c @ n_world (row form: n @ R_w2c^T)
    n_cam = (nmap.reshape(-1, 3) @ Rwc.T).reshape(H, W, 3)
    return rgb, n_cam.transpose(2, 0, 1).astype(np.float32)


def sample_scene_points(rng, n_ground=2500, n_box=400, noise=0.05,
                        n_sky=6000, sky_radius=45.0):
    """COLMAP-style sparse init: noisy surface samples with noisy albedo,
    plus a far sky-dome shell (visible sky needs *some* seed geometry —
    gradient-driven densification can only clone existing Gaussians, so
    pixels nothing renders to would otherwise never receive gradient)."""
    pts, cols = [], []
    if n_sky:
        # upper-hemisphere directions (y is DOWN in this convention)
        d = rng.normal(size=(n_sky, 3))
        d[:, 1] = -np.abs(d[:, 1])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        sky_t = np.clip(-d[:, 1], 0.0, 1.0) ** 0.7
        c = SKY_BOT[None] * (1 - sky_t[:, None]) + SKY_TOP[None] * sky_t[:, None]
        pts.append(np.array([0.0, 0.0, 10.0]) + d * sky_radius)
        cols.append(c)
    g = rng.uniform([-12, 1.5, 1.0], [12, 1.5, 40.0], (n_ground, 3))
    checker = ((np.floor(g[:, 0]) + np.floor(g[:, 2])) % 2) == 0
    c = np.where(checker[:, None], CHECKER_A, CHECKER_B)
    pts.append(g)
    cols.append(_shade(c, np.array([0, -1.0, 0])))
    for box in BOXES:
        lo, hi = _box_bounds(box)
        base_y = 1.5
        height = hi[1] - lo[1]
        lo = lo.copy(); hi = hi.copy()
        lo[1], hi[1] = base_y - height, base_y
        albedo = np.array(box[2])
        for axis in range(3):
            for side in (0, 1):
                m = n_box // 6 + 1
                p = rng.uniform(lo, hi, (m, 3))
                p[:, axis] = hi[axis] if side else lo[axis]
                normal = np.zeros(3)
                normal[axis] = 1.0 if side else -1.0
                pts.append(p)
                cols.append(np.tile(_shade(albedo, normal), (m, 1)))
    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    cols = np.clip(
        cols + rng.normal(0, noise, cols.shape), 0, 1).astype(np.float32)
    return pts, cols


# -- dynamic-object oracle: a "vehicle" box crossing the street -------------
MOVER_SIZE = (1.4, 1.0, 2.0)
MOVER_ALBEDO = (0.85, 0.55, 0.20)
MOVER_INSTANCE = 26001  # KITTI-360 vehicle-range semantic id


def mover_center(frame: int, n_frames: int):
    s = frame / max(n_frames - 1, 1)
    return (-2.2 + 4.4 * s, 0.0, 8.0 + 3.0 * s)


def mover_box(frame: int, n_frames: int):
    return (mover_center(frame, n_frames), MOVER_SIZE, MOVER_ALBEDO)


def mover_box2world(frame: int, n_frames: int) -> np.ndarray:
    """Canonical [-0.5, 0.5]^3 -> world transform of the mover at `frame`
    (pure translation + per-axis scale; base resting on the ground plane)."""
    (cx, _, cz) = mover_center(frame, n_frames)
    sx, sy, sz = MOVER_SIZE
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    m[:3, 3] = [cx, 1.5 - sy / 2.0, cz]
    return m


def mover_canonical_points(rng, n=420, noise=0.02):
    """Noisy surface samples of the mover in its CANONICAL frame, with
    shaded albedo colors (rotation is identity, so canonical face normals
    are world face normals)."""
    pts, cols = [], []
    albedo = np.array(MOVER_ALBEDO)
    m = n // 6 + 1
    for axis in range(3):
        for side in (-0.5, 0.5):
            p = rng.uniform(-0.5, 0.5, (m, 3))
            p[:, axis] = side
            normal = np.zeros(3)
            normal[axis] = np.sign(side)
            pts.append(p)
            cols.append(np.tile(_shade(albedo, normal), (m, 1)))
    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    pts = np.clip(pts + rng.normal(0, noise, pts.shape), -0.49, 0.49)
    return pts.astype(np.float32), np.clip(cols, 0, 1).astype(np.float32)


def street_camera_infos(n: int, H: int, W: int, fovx=1.2, fovy=0.7,
                        render_gt=False, moving_box=False,
                        render_normal=False, stereo_baseline=0.0):
    """Forward-facing camera arc (KITTI-like ego motion with slight yaw)
    as CameraInfo records, the same poses as the JAX package's
    `street_camera_infos`. With `render_gt=True` each record carries a
    ray-traced ground-truth image (the default here is False, where the JAX
    package's is True: the full-width callers render their own ground
    truth); `moving_box=True` composites the mover (`mover_box`) into it;
    `render_normal=True` attaches the camera-space normal map. With
    `stereo_baseline > 0` two cameras per frame, offset +-baseline/2 along
    the camera x axis."""
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
            img, nrm = None, None
            if render_gt:
                extra = [mover_box(i, n)] if moving_box else []
                out = raytrace(Rw2c.T, T, H, W, fovx, fovy,
                               extra_boxes=extra, return_normal=render_normal)
                img, nrm = out if render_normal else (out, None)
            suffix = f"_{ei}" if stereo_baseline > 0 else ""
            infos.append(CameraInfo(
                uid=uid, R=Rw2c.T, T=T, FovX=fovx, FovY=fovy, K=K,
                image=img, image_path="",
                image_name=f"street_{i:03d}{suffix}",
                normal=nrm, normal_path="", width=W, height=H, frame=i))
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


# ---------------------------------------------------------------------------
# A KITTI-360 directory on disk
# ---------------------------------------------------------------------------


def kitti360_frame_paths(root, seq: str, cam: int, frame: int):
    """(image PNG, normal map .npy) paths of a camera's frame, where the
    KITTI-360 reader looks for them."""
    name = f"{int(frame):010d}"
    return (os.path.join(root, "data_2d_raw", seq, f"image_{cam:02d}",
                         "data_rect", name + ".png"),
            os.path.join(root, "data_2d_normal_omnidata_all", seq,
                         f"image_{cam:02d}", name + "_norm.npy"))


def _row(values) -> str:
    return " ".join(repr(float(v)) for v in np.ravel(values))


def _box_xml(name: str, gid: int, frame: int, box2world) -> str:
    sem, inst = divmod(int(gid), 1000)
    return (f"  <{name}>\n    <semanticId>{sem}</semanticId>\n"
            f"    <instanceId>{inst}</instanceId>\n"
            f"    <timestamp>{int(frame)}</timestamp>\n"
            f"    <label>car</label>\n"
            f"    <transform type_id=\"opencv-matrix\">\n"
            f"      <rows>4</rows><cols>4</cols><dt>f</dt>\n"
            f"      <data>{_row(box2world)}</data>\n"
            f"    </transform>\n  </{name}>\n")


def write_kitti360_segment(root, seq: str, start_frame: int, end_frame: int,
                           K: np.ndarray, width: int, height: int,
                           cam0_to_world: dict, baseline: float,
                           static: tuple, colmap: tuple, dynamic: tuple,
                           boxes: dict) -> None:
    """Write a KITTI-360 segment the readers take, images and normal maps
    aside (`kitti360_frame_paths` says where they go):

      calibration/perspective.txt        P_rect_0x from K, R_rect = I,
                                         S_rect = width height;
      calibration/calib_cam_to_pose.txt  image_00 at the pose, image_01
                                         `baseline` along its x axis;
      data_poses/<seq>/poses.txt         {frame: camera 0's [4, 4]
                                         camera-to-world} (`cam0_to_world`);
      data_3d_semantics/train/<seq>/static/<segment>.ply
                                         static = (xyz, rgb uint8, visible);
      data_3d_colmap_processed/train/<seq>/static/<segment>/points3D.ply
                                         colmap = (xyz, rgb uint8);
      data_3d_semantics/train/<seq>/dynamic/<segment>.ply
                                         dynamic = (xyz, rgb uint8, global
                                         instance id, frame, semantic id,
                                         visible);
      data_3d_bboxes/train/<seq>.xml     boxes = {frame: {global id
                                         (semantic * 1000 + instance):
                                         box-to-world [4, 4]}}.

    Every float is written exactly (repr), so the readers get the values
    given."""
    root = Path(root)
    seg = f"{int(start_frame):010d}_{int(end_frame):010d}"
    calib = root / "calibration"
    calib.mkdir(parents=True, exist_ok=True)
    P = np.zeros((3, 4))
    P[:, :3] = K
    lines = []
    for cam in ("00", "01"):
        lines += [f"P_rect_{cam}: {_row(P)}", f"R_rect_{cam}: {_row(np.eye(3))}",
                  f"S_rect_{cam}: {int(width)} {int(height)}"]
    (calib / "perspective.txt").write_text("\n".join(lines) + "\n")
    right = np.eye(4)[:3]
    right[0, 3] = baseline
    (calib / "calib_cam_to_pose.txt").write_text(
        f"image_00: {_row(np.eye(4)[:3])}\nimage_01: {_row(right)}\n")
    poses = root / "data_poses" / seq
    poses.mkdir(parents=True, exist_ok=True)
    (poses / "poses.txt").write_text("".join(
        f"{int(f)} {_row(np.asarray(m)[:3])}\n"
        for f, m in sorted(cam0_to_world.items())))

    sem_dir = root / "data_3d_semantics" / "train" / seq
    xyz, rgb, visible = static
    (sem_dir / "static").mkdir(parents=True, exist_ok=True)
    ply_io.write_ply(sem_dir / "static" / f"{seg}.ply",
                     ply_io.make_vertex_array({
                         "x": xyz[:, 0].astype(np.float32),
                         "y": xyz[:, 1].astype(np.float32),
                         "z": xyz[:, 2].astype(np.float32),
                         "red": rgb[:, 0].astype(np.uint8),
                         "green": rgb[:, 1].astype(np.uint8),
                         "blue": rgb[:, 2].astype(np.uint8),
                         "visible": np.asarray(visible, np.uint8)}))
    cxyz, crgb = colmap
    cdir = (root / "data_3d_colmap_processed" / "train" / seq / "static"
            / seg)
    cdir.mkdir(parents=True, exist_ok=True)
    storePly(str(cdir / "points3D.ply"), cxyz, crgb)
    dxyz, drgb, dinst, dframe, dsem, dvis = dynamic
    (sem_dir / "dynamic").mkdir(parents=True, exist_ok=True)
    ply_io.write_ply(sem_dir / "dynamic" / f"{seg}.ply",
                     ply_io.make_vertex_array({
                         "x": dxyz[:, 0].astype(np.float32),
                         "y": dxyz[:, 1].astype(np.float32),
                         "z": dxyz[:, 2].astype(np.float32),
                         "red": drgb[:, 0].astype(np.uint8),
                         "green": drgb[:, 1].astype(np.uint8),
                         "blue": drgb[:, 2].astype(np.uint8),
                         "semantic": np.asarray(dsem, np.int32),
                         "instance": np.asarray(dinst, np.int32),
                         "visible": np.asarray(dvis, np.uint8),
                         "timestamp": np.asarray(dframe, np.int32)}))
    bdir = root / "data_3d_bboxes" / "train"
    bdir.mkdir(parents=True, exist_ok=True)
    objs = [(gid, f, m) for f, d in sorted(boxes.items())
            for gid, m in sorted(d.items())]
    (bdir / f"{seq}.xml").write_text(
        "<?xml version=\"1.0\"?>\n<opencv_storage>\n"
        + "".join(_box_xml(f"object_{i}", gid, f, m)
                  for i, (gid, f, m) in enumerate(objs))
        + "</opencv_storage>\n")
