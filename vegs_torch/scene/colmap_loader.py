"""COLMAP binary/text model parsers (port of vegs_tpu/scene/colmap_loader.py,
numpy only).

The standard COLMAP read_model behaviour: cameras/images/points3D in both
.bin and .txt form, plus qvec<->rotmat helpers, implemented from the COLMAP
format specification.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        cid = int(el[0])
        out[cid] = ColmapCamera(cid, el[1], int(el[2]), int(el[3]),
                                np.array(el[4:], dtype=np.float64))
    return out


def read_images_binary(path) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * npts), dtype=np.dtype(
                [("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            out[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"),
                np.column_stack([data["x"], data["y"]]), data["id"].copy(),
            )
    return out


def read_images_text(path) -> dict[int, ColmapImage]:
    out = {}
    lines = [l.strip() for l in open(path)
             if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(pts, dtype=np.float64).reshape(-1, 3) if pts else np.zeros((0, 3))
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                               arr[:, :2], arr[:, 2].astype(np.int64))
    return out


def read_points3D_binary(path):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, errors [N])."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        for i in range(num):
            rec = f.read(8 + 24 + 3 + 8)
            _, x, y, z, r, g, b, e = struct.unpack("<QdddBBBd", rec)
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3D_text(path):
    xyz, rgb, err = [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        xyz.append([float(v) for v in el[1:4]])
        rgb.append([int(v) for v in el[4:7]])
        err.append(float(el[7]))
    return (np.array(xyz).reshape(-1, 3), np.array(rgb, np.uint8).reshape(-1, 3),
            np.array(err))


def write_cameras_text(cameras: dict[int, ColmapCamera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list\n")
        for cam in cameras.values():
            params = " ".join(str(p) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: dict[int, ColmapImage], path) -> None:
    with open(path, "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")
