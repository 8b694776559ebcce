"""The port's dataset loaders (`vegs_torch.scene`: kitti360_loader,
colmap_loader, kitti_loader, dataset_readers, Scene) against vegs_tpu's,
on synthetic datasets written here. Every loader output is held EXACTLY:
points, colours, visibility and instance filters, cameras (R, T, FoV, K,
names, paths, frames), box transforms, the train/test split and the nerf++
normalization.

  * KITTI-360: a toy segment (`toy_kitti360_root`: 4 frames of 48x64
    stereo, LiDAR points with hidden ones the reader drops, COLMAP points,
    one vehicle box in frames 1-3 with its dynamic points, a non-vehicle
    object whose points and box are dropped, PNG frames and .npy normal
    maps) through `readKITTI360SceneInfo` (the `.cache` PLY written in
    the working directory, a temporary one here), and `Scene(cfg)` from
    the config alone: the same camera order under the same seed, the same
    seeded static and box fields, the same preloaded images.
  * COLMAP: a 3-image model in binary and in text form, through the
    parsers and `readColmapSceneInfo`.
  * KITTI tracking: a copy of tests/test_kitti_tracking.py's
    `tracking_root` with PNG frames and static/dynamic PLYs, through the
    calibration, pose and tracklet parsers and `readKITTISceneInfo`
    (image sizes read with PIL, as in the JAX reader).
  * Blender: transforms JSON and RGBA PNGs through
    `readNerfSyntheticInfo` (the RGBA composite on white).
"""

import json
import os
import random
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from vegs_tpu.config import VegsConfig as JConfig
from vegs_tpu.scene import Scene as JScene
from vegs_tpu.scene import colmap_loader as jcol
from vegs_tpu.scene import dataset_readers as jread
from vegs_tpu.scene import kitti360_loader as jk360
from vegs_tpu.scene import kitti_loader as jkl
from vegs_torch.config import VegsConfig as TConfig
from vegs_torch.scene import Scene as TScene
from vegs_torch.scene import colmap_loader as tcol
from vegs_torch.scene import dataset_readers as tread
from vegs_torch.scene import kitti360_loader as tk360
from vegs_torch.scene import kitti_loader as tkl
from vegs_torch.utils.synthetic import (kitti360_frame_paths, unit_normal_map,
                                        write_kitti360_segment)


def write_png(path, img):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    Image.fromarray(img).save(path)


SEQ = "2013_05_28_drive_0009_sync"
START, N_FRAMES = 3972, 4
H, W = 48, 64
K = np.array([[40.0, 0.0, 31.5], [0.0, 40.0, 23.5], [0.0, 0.0, 1.0]])
CAR, OTHER = 26001, 41005       # a vehicle and a non-vehicle object


def toy_box2world(i: int) -> np.ndarray:
    """The car's box-to-world in the segment's i-th frame: yawed 0.3 rad,
    1.2 x 0.8 x 1.0, moving 0.1 along x a frame."""
    c, s = np.cos(0.3), np.sin(0.3)
    m = np.eye(4)
    m[:3, :3] = (np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
                 @ np.diag([1.2, 0.8, 1.0]))
    m[:3, 3] = [0.3 + 0.1 * i, 0.2, 3.0]
    return m


def toy_kitti360_root(root, seed: int = 0) -> str:
    """Write the toy KITTI-360 segment of the module docstring under
    `root` (frames START..START+3, --end_frame START+4). The car is
    annotated from the second frame on: the first frame holds a test
    camera, and the JAX CLI's report of a frame with boxes fails
    (tests/test_torch_cli.py)."""
    rng = np.random.default_rng(seed)
    frames = list(range(START, START + N_FRAMES))
    poses = {}
    for i, f in enumerate(frames):
        yaw = 0.05 * np.sin(i)
        c, s = np.cos(yaw), np.sin(yaw)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        m[:3, 3] = [0.05 * i, 0.0, -1.0 + 0.3 * i]
        poses[f] = m

    def pts(n):
        z = rng.uniform(2.0, 6.0, n)
        return np.stack([z * rng.uniform(-0.6, 0.6, n),
                         z * rng.uniform(-0.45, 0.45, n), z], 1)

    xyz = pts(180)
    rgb = rng.integers(40, 220, (180, 3))
    visible = np.r_[np.ones(150), np.zeros(30)]
    colmap = (pts(40), rng.integers(40, 220, (40, 3)))
    canon = rng.uniform(-0.45, 0.45, (48, 3))
    dyn = [[] for _ in range(6)]
    for i, f in enumerate(frames[1:], start=1):
        world = (np.c_[canon, np.ones(48)] @ toy_box2world(i).T)[:, :3]
        for lst, v in zip(dyn, (world, rng.integers(100, 200, (48, 3)),
                                np.full(48, CAR), np.full(48, f),
                                np.full(48, 26), np.r_[np.ones(44),
                                                       np.zeros(4)])):
            lst.append(v)
    for lst, v in zip(dyn, (pts(10), rng.integers(0, 255, (10, 3)),
                            np.full(10, OTHER), np.full(10, frames[1]),
                            np.full(10, 41), np.ones(10))):
        lst.append(v)
    boxes = {f: {CAR: toy_box2world(i), OTHER: toy_box2world(0)}
             for i, f in enumerate(frames) if i}
    write_kitti360_segment(root, SEQ, START, START + N_FRAMES, K, W, H,
                           poses, 0.3, (xyz, rgb, visible), colmap,
                           tuple(np.concatenate(v) for v in dyn), boxes)
    y, x = np.mgrid[0:H, 0:W]
    for f in frames:
        for cam in (0, 1):
            img_path, normal_path = kitti360_frame_paths(root, SEQ, cam, f)
            img = np.stack([(x * 3 + f) % 256, (y * 5 + 40 * cam) % 256,
                            rng.integers(0, 256, (H, W))], -1)
            write_png(img_path, img.astype(np.uint8))
            os.makedirs(os.path.dirname(normal_path), exist_ok=True)
            np.save(normal_path, unit_normal_map(H, W, seed=2 * f + cam))
    return str(root)


@pytest.fixture(scope="module")
def kitti360_root(tmp_path_factory):
    return toy_kitti360_root(tmp_path_factory.mktemp("k360") / "root")


def _same_cameras(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("uid", "image_path", "image_name", "width", "height",
                  "normal_path", "frame", "cam_idx", "FovX", "FovY"):
            assert getattr(x, k) == getattr(y, k), k
        for k in ("R", "T", "K"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
        for k in ("image", "normal"):
            if getattr(y, k) is None:
                assert getattr(x, k) is None
            else:
                np.testing.assert_array_equal(getattr(x, k), getattr(y, k))


def _same_boxes(a, b):
    assert sorted(a) == sorted(b)
    for f in a:
        assert sorted(a[f]) == sorted(b[f])
        for i in a[f]:
            np.testing.assert_array_equal(a[f][i].box2world, b[f][i].box2world)


def test_kitti360_loader_matches_jax(kitti360_root):
    for cam_id in (0, 1):
        t = tk360.CameraPerspective(kitti360_root, SEQ, cam_id=cam_id)
        j = jk360.CameraPerspective(kitti360_root, SEQ, cam_id=cam_id)
        assert (t.width, t.height) == (j.width, j.height) == (W, H)
        np.testing.assert_array_equal(t.K, j.K)
        np.testing.assert_array_equal(t.frames, j.frames)
        for f in j.frames:
            np.testing.assert_array_equal(t.cam2world[f], j.cam2world[f])
    tb, ti = tk360.read_kitti360_3d_annotations(kitti360_root, SEQ, START,
                                                START + N_FRAMES)
    jb, ji = jk360.read_kitti360_3d_annotations(kitti360_root, SEQ, START,
                                                START + N_FRAMES)
    assert ti == ji == [CAR]
    _same_boxes(tb, jb)
    np.testing.assert_array_equal(tb[START + 2][CAR].box2world,
                                  toy_box2world(2))
    to = tk360.load_annotations_3d(os.path.join(kitti360_root,
                                                "data_3d_bboxes"), SEQ)
    jo = jk360.load_annotations_3d(os.path.join(kitti360_root,
                                                "data_3d_bboxes"), SEQ)
    assert sorted(to) == sorted(jo) == [CAR, OTHER]


def test_read_kitti360_scene_info_matches_jax(kitti360_root, tmp_path,
                                             monkeypatch):
    monkeypatch.chdir(tmp_path)  # the reader writes .cache/ here
    kw = dict(eval=True, seq=SEQ, start_frame=START,
              end_frame=START + N_FRAMES, colmap_data_type="_processed")
    t = tread.readKITTI360SceneInfo(kitti360_root, **kw)
    j = jread.readKITTI360SceneInfo(kitti360_root, **kw)
    assert len(t.point_cloud.points) == 150 + 40   # hidden points dropped
    for k in ("points", "colors"):
        np.testing.assert_array_equal(getattr(t.point_cloud, k),
                                      getattr(j.point_cloud, k))
    for k in ("points", "colors", "instances", "timestamps"):
        np.testing.assert_array_equal(getattr(t.dyn_point_cloud, k),
                                      getattr(j.dyn_point_cloud, k))
    assert set(t.dyn_point_cloud.instances.tolist()) == {CAR}
    _same_cameras(t.train_cameras, j.train_cameras)
    _same_cameras(t.test_cameras, j.test_cameras)
    assert [c.uid for c in t.test_cameras] == [0]
    _same_boxes(t.train_bboxes, j.train_bboxes)
    _same_boxes(t.test_bboxes, j.test_bboxes)
    assert t.instances_info == j.instances_info == [CAR]
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(t.nerf_normalization[k],
                                      j.nerf_normalization[k])
    assert t.ply_path == j.ply_path
    assert os.path.exists(tmp_path / t.ply_path)
    # preloaded frames and normal maps
    kw["eval"] = False
    tp = tread.readKITTI360SceneInfo(kitti360_root, preload_image=True, **kw)
    jp = jread.readKITTI360SceneInfo(kitti360_root, preload_image=True, **kw)
    _same_cameras(tp.train_cameras, jp.train_cameras)
    assert tp.train_cameras[0].image.shape == (3, H, W)


def _configs(root, model_path, extra=()):
    argv = ["--source_path", root, "--model_path", str(model_path),
            "--data_type", "kitti360", "--seq", SEQ,
            "--start_frame", str(START), "--end_frame",
            str(START + N_FRAMES), "--eval", *extra]
    from vegs_torch.config import parse_config as tparse
    from vegs_tpu.config import parse_config as jparse

    return tparse(argv), jparse(argv)


def test_scene_from_config_matches_jax(kitti360_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tcfg, jcfg = _configs(kitti360_root, tmp_path / "model",
                          ["--gaussian_box_model_init_opacity", "0.2"])
    assert isinstance(tcfg, TConfig) and isinstance(jcfg, JConfig)
    random.seed(7)
    ts = TScene(tcfg.model, tcfg.data, tcfg.box, device="cpu")
    random.seed(7)
    js = JScene(jcfg.model, jcfg.data, jcfg.box)
    assert ([(c.image_path, c.uid) for c in ts.train_cameras]
            == [(c.image_path, c.uid) for c in js.train_cameras])
    assert ([c.frame for c in ts.train_cameras]
            != sorted(c.frame for c in ts.train_cameras))  # shuffled
    for tc, jc in zip(ts.train_cameras + ts.test_cameras,
                      js.train_cameras + js.test_cameras):
        for k in ("world_view_transform", "full_proj_transform",
                  "camera_center", "K"):
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
        assert (tc.image_path, tc.normal_path) == (jc.image_path,
                                                   jc.normal_path)
    assert ts.cameras_extent == js.cameras_extent

    def same_field(t, j):
        for k in ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                  "opacity_logit", "valid"):
            np.testing.assert_array_equal(
                getattr(t, k).detach().numpy(), np.asarray(getattr(j, k)),
                err_msg=k)

    same_field(ts.gaussians, js.gaussians)
    assert list(ts.box_gaussians) == list(js.box_gaussians) == [CAR]
    same_field(ts.box_gaussians[CAR], js.box_gaussians[CAR])
    op = torch.sigmoid(ts.box_gaussians[CAR].opacity_logit[0]).item()
    assert op == pytest.approx(0.2, rel=1e-6)
    # lazily read frames and normal maps equal the JAX package's
    for tc, jc in zip(ts.train_cameras[:3], js.train_cameras[:3]):
        np.testing.assert_array_equal(tc.original_image, jc.original_image)
        np.testing.assert_array_equal(tc.world_normal(), jc.world_normal())
    # preloaded
    random.seed(7)
    tpre = TScene(tcfg.model, tcfg.data, tcfg.box, preload_image=True,
                  device="cpu")
    for a, b in zip(tpre.train_cameras, ts.train_cameras):
        np.testing.assert_array_equal(a.image, b.original_image)


# -- COLMAP -------------------------------------------------------------------


def _colmap_model(rng):
    cams = {1: tcol.ColmapCamera(1, "PINHOLE", 64, 48,
                                 np.array([40.0, 41.0, 32.0, 24.0])),
            2: tcol.ColmapCamera(2, "SIMPLE_PINHOLE", 64, 48,
                                 np.array([39.0, 31.5, 23.5]))}
    imgs = {}
    for i in range(1, 4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        imgs[i] = tcol.ColmapImage(
            i, q, rng.normal(size=3), 1 + i % 2, f"img_{4 - i}.png",
            rng.uniform(0, 60, (5, 2)), rng.integers(-1, 50, 5))
    xyz = rng.normal(size=(30, 3))
    rgb = rng.integers(0, 255, (30, 3)).astype(np.uint8)
    err = rng.uniform(0, 1, 30)
    return cams, imgs, xyz, rgb, err


def _write_colmap_binary(d, cams, imgs, xyz, rgb, err):
    ids = {name: mid for mid, (name, _) in tcol.CAMERA_MODELS.items()}
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, ids[c.model], c.width,
                                c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), p in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, p))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            f.write(struct.pack("<QdddBBBd", i, *p, *c, e))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ii", 1, 0) + struct.pack("<ii", 2, 1))


def _write_colmap_text(d, cams, imgs, xyz, rgb, err):
    tcol.write_cameras_text(cams, d / "cameras.txt")
    with open(d / "images.txt", "w") as f:
        f.write("# Image list\n")
        for im in imgs.values():
            f.write(f"{im.id} {' '.join(repr(float(v)) for v in im.qvec)} "
                    f"{' '.join(repr(float(v)) for v in im.tvec)} "
                    f"{im.camera_id} {im.name}\n")
            f.write(" ".join(f"{x!r} {y!r} {p}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3D_ids)) + "\n")
    with open(d / "points3D.txt", "w") as f:
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            f.write(f"{i} {' '.join(repr(float(v)) for v in p)} "
                    f"{' '.join(str(int(v)) for v in c)} {float(e)!r} 1 0 2 1\n")


@pytest.mark.parametrize("form", ["binary", "text"])
def test_colmap_loader_matches_jax(tmp_path, form):
    model = _colmap_model(np.random.default_rng(1))
    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    (_write_colmap_binary if form == "binary" else _write_colmap_text)(
        sparse, *model)
    ext = "bin" if form == "binary" else "txt"
    read = {"binary": ("read_cameras_binary", "read_images_binary",
                       "read_points3D_binary"),
            "text": ("read_cameras_text", "read_images_text",
                     "read_points3D_text")}[form]
    tc, ti, tp = (getattr(tcol, n)(sparse / f"{s}.{ext}") for n, s in
                  zip(read, ("cameras", "images", "points3D")))
    jc, ji, jp = (getattr(jcol, n)(sparse / f"{s}.{ext}") for n, s in
                  zip(read, ("cameras", "images", "points3D")))
    for k, c in tc.items():
        assert (c.model, c.width, c.height) == (jc[k].model, jc[k].width,
                                                jc[k].height)
        np.testing.assert_array_equal(c.params, jc[k].params)
        np.testing.assert_array_equal(c.params, model[0][k].params)
    for k, im in ti.items():
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(im, f), getattr(ji[k], f))
            np.testing.assert_array_equal(getattr(im, f),
                                          getattr(model[1][k], f))
        assert (im.name, im.camera_id) == (ji[k].name, ji[k].camera_id)
    for a, b, want in zip(tp, jp, model[2:]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)
    for q in (model[1][1].qvec, np.array([1.0, 0, 0, 0])):
        R = tcol.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcol.qvec2rotmat(q))
        np.testing.assert_array_equal(tcol.rotmat2qvec(R), jcol.rotmat2qvec(R))
    t = tread.readColmapSceneInfo(str(tmp_path), eval=True, llffhold=2)
    (sparse / "points3D.ply").unlink()
    j = jread.readColmapSceneInfo(str(tmp_path), eval=True, llffhold=2)
    _same_cameras(t.train_cameras, j.train_cameras)
    _same_cameras(t.test_cameras, j.test_cameras)
    assert [c.image_name for c in t.train_cameras + t.test_cameras] == [
        "img_2", "img_1", "img_3"]
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t.point_cloud, k),
                                      getattr(j.point_cloud, k))
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(t.nerf_normalization[k],
                                      j.nerf_normalization[k])


# -- KITTI tracking -------------------------------------------------------------


def _tracking_root(tmp_path):
    """tests/test_kitti_tracking.py's `tracking_root`, with 48x64 PNG
    frames of the stereo cameras 2 and 3 and the static and dynamic PLYs
    the scene reader takes."""
    seq = "0001"
    basedir = tmp_path / "training"
    for d in ("calib", "oxts", "label_02"):
        (basedir / d).mkdir(parents=True)
    P = "7.2e+02 0 6.0e+02 0 0 7.2e+02 1.8e+02 0 0 0 1.0e+00 0"
    (basedir / "calib" / f"{seq}.txt").write_text(
        f"P0: {P}\nP1: {P}\nP2: {P}\nP3: {P}\n"
        "R_rect: 1 0 0 0 1 0 0 0 1\n"
        "Tr_velo_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n"
        "Tr_imu_velo: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    lines = [f"49.0 {8.0 + i * 1e-5} 110.0 0 0 0 " + "0 " * 24
             for i in range(4)]
    (basedir / "oxts" / f"{seq}.txt").write_text("\n".join(lines) + "\n")
    rows = [f"{f} 1 Car 0 0 0 0 0 50 50 1.5 1.7 4.0 {1.0 + f * 2.0} 1.0 8.0 0.1"
            for f in range(4)]
    rows.append("0 2 Car 0 0 0 0 0 50 50 1.5 1.7 4.0 2.0 1.0 6.0 0.0")
    rows.append("3 2 Car 0 0 0 0 0 50 50 1.5 1.7 4.0 2.1 1.0 6.0 0.0")
    rows.append("1 -1 DontCare 0 0 0 0 0 1 1 0 0 0 0 0 0 0")
    (basedir / "label_02" / f"{seq}.txt").write_text("\n".join(rows) + "\n")
    rng = np.random.default_rng(2)
    for cam in ("image_02", "image_03"):
        for f in range(4):
            write_png(basedir / cam / seq / f"{f:06d}.png",
                      rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
    sem = basedir / "3d_semantics"
    (sem / "static").mkdir(parents=True)
    (sem / "dynamic").mkdir(parents=True)
    n = 60
    tread.storePly(str(sem / "static" / f"{seq}.ply"),
                   rng.normal(size=(n, 3)), rng.integers(0, 255, (n, 3)))
    from vegs_torch.scene import ply_io

    ply_io.write_ply(sem / "dynamic" / f"{seq}.ply", ply_io.make_vertex_array({
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
        "z": rng.normal(size=n).astype(np.float32),
        "red": rng.integers(0, 255, n).astype(np.uint8),
        "green": rng.integers(0, 255, n).astype(np.uint8),
        "blue": rng.integers(0, 255, n).astype(np.uint8),
        "semantic": rng.integers(0, 4, n).astype(np.int32),
        "instance": rng.integers(1, 3, n).astype(np.int32),
        "visible": rng.integers(0, 2, n).astype(np.uint8),
        "timestamp": rng.integers(0, 4, n).astype(np.int32)}))
    return tmp_path, seq


def test_kitti_tracking_loader_matches_jax(tmp_path, monkeypatch):
    root, seq = _tracking_root(tmp_path)
    calib_path = root / "training" / "calib" / f"{seq}.txt"
    tc, jc = (m.tracking_calib_from_txt(calib_path) for m in (tkl, jkl))
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k])
    oxts = str(root / "training" / "oxts" / f"{seq}.txt")
    tpose, jpose = (m.get_poses_calibration(str(root / "training"), oxts)[0]
                    for m in (tkl, jkl))
    np.testing.assert_array_equal(tpose, jpose)
    label = str(root / "training" / "label_02" / f"{seq}.txt")
    tv, tm, tb = tkl.get_obj_pose_tracking(label, tpose, tc)
    jv, jm, jb = jkl.get_obj_pose_tracking(label, jpose, jc)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)
    assert sorted(tm) == sorted(jm)
    boxes = np.array([[0.0, 0, 0, 2, 4, 1.5, 0.3], [1.0, 2, 0, 1, 1, 1, -0.4]])
    np.testing.assert_array_equal(tkl.boxes_to_corners_3d(boxes),
                                  jkl.boxes_to_corners_3d(boxes))
    pts = np.random.default_rng(3).uniform(-1, 1, (40, 3))
    np.testing.assert_array_equal(
        tkl.is_within_3d_box(pts, tkl.boxes_to_corners_3d(boxes)),
        jkl.is_within_3d_box(pts, jkl.boxes_to_corners_3d(boxes)))
    for a, b in zip(tkl.points_to_canonical(pts, boxes[0]),
                    jkl.points_to_canonical(pts, boxes[0])):
        np.testing.assert_array_equal(a, b)

    monkeypatch.chdir(tmp_path)
    t = tread.readKITTISceneInfo(str(root), seq)
    j = jread.readKITTISceneInfo(str(root), seq)
    _same_cameras(t.train_cameras, j.train_cameras)
    _same_cameras(t.test_cameras, j.test_cameras)
    assert t.train_cameras[0].width == 64 and t.train_cameras[0].height == 48
    for k in ("points", "colors"):
        np.testing.assert_array_equal(getattr(t.point_cloud, k),
                                      getattr(j.point_cloud, k))
    for k in ("points", "colors", "instances", "timestamps"):
        np.testing.assert_array_equal(getattr(t.dyn_point_cloud, k),
                                      getattr(j.dyn_point_cloud, k))
    _same_boxes(t.train_bboxes, j.train_bboxes)
    _same_boxes(t.test_bboxes, j.test_bboxes)
    assert t.instances_info == j.instances_info and t.instances_info
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(t.nerf_normalization[k],
                                      j.nerf_normalization[k])


# -- Blender ----------------------------------------------------------------------


@pytest.mark.parametrize("white", [False, True])
def test_blender_reader_matches_jax(tmp_path, white):
    rng = np.random.default_rng(4)
    frames = []
    for split in ("train", "test"):
        fr = []
        for i in range(2):
            name = f"{split}/r_{i}"
            rgba = rng.integers(0, 256, (24, 32, 4)).astype(np.uint8)
            write_png(tmp_path / f"{name}.png", rgba)
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3) + [0, 0, 4]
            fr.append({"file_path": name, "transform_matrix": c2w.tolist()})
        (tmp_path / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.7, "frames": fr}))
        frames += fr
    np.random.seed(5)
    t = tread.readNerfSyntheticInfo(str(tmp_path), white_background=white)
    (tmp_path / "points3d.ply").unlink()
    np.random.seed(5)
    j = jread.readNerfSyntheticInfo(str(tmp_path), white_background=white)
    _same_cameras(t.train_cameras, j.train_cameras)
    assert len(t.train_cameras) == 4 and not t.test_cameras
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t.point_cloud, k),
                                      getattr(j.point_cloud, k))
