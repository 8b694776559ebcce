"""ctypes bindings for the native host-side library (port of
vegs_tpu/native.py).

`native/vegs_native.cpp`: a multithreaded binary-PLY column reader for the
multi-hundred-MB KITTI-360 clouds, and the mean squared distance to the k
nearest neighbours (the reference's distCUDA2) over a uniform grid. The
library is compiled from that source with `g++` on first use (never at
import) into `build/vegs_torch/<source hash>/` at the root of the checkout
and loaded from there; the `.so` committed beside the source, built
elsewhere for that machine's CPU, is not used. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "vegs_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "vegs_torch"
# portable flags: no -march=native, so the build runs on any x86-64 host
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvegs_native.so"


def build() -> Path:
    """Compile the library if its build is missing; returns its path.
    Raises RuntimeError when g++ fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{r.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.vegs_knn_mean_sq_dist.restype = ctypes.c_int
            lib.vegs_knn_mean_sq_dist.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ]
            lib.vegs_read_ply_columns.restype = ctypes.c_int64
            lib.vegs_read_ply_columns.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """[N, 3] -> [N] float32 mean squared distance to the k nearest
    neighbours."""
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.float32)
    rc = load().vegs_knn_mean_sq_dist(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"vegs_knn_mean_sq_dist failed ({rc})")
    return out


def read_ply_columns(path, names: Sequence[str],
                     n_hint: Optional[int] = None) -> np.ndarray:
    """Named vertex properties of a binary little-endian PLY as a
    [len(names), n] float32 array; raises ValueError on a layout the
    reader does not handle."""
    lib = load()
    if n_hint is None:
        # a header-only pass in Python sizes the buffer
        with open(path, "rb") as f:
            n_hint = 0
            for raw in f:
                line = raw.decode("ascii", "replace")
                if line.startswith("element vertex"):
                    n_hint = int(line.split()[2])
                if line.startswith("end_header"):
                    break
    out = np.empty((len(names), n_hint), np.float32)
    n = lib.vegs_read_ply_columns(
        str(path).encode(), ";".join(names).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    if n < 0:
        raise ValueError(f"{path}: unsupported PLY layout for {list(names)}")
    return out[:, :n]
