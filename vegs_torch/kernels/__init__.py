"""Build and load the port's CUDA kernels (`vegs_torch/csrc/*.cu`).

Each `.cu` file becomes its own shared library with a plain C interface,
compiled by `nvcc` for Hopper (`sm_90a`) and loaded with `ctypes`. Builds
are keyed by a hash of every source in `csrc/` plus the compiler flags, go
under `build/vegs_torch/<hash>/` at the root of the checkout, and happen on
first use (never at import): all missing libraries are compiled by parallel
`nvcc` processes started together. Nothing is built from outside the repo.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vegs_torch"

# library name -> source file (each includes the shared headers in csrc/)
SOURCES = {"blend_fwd": "blend_fwd.cu", "blend_bwd": "blend_bwd.cu",
           "satcount": "satcount.cu", "segreduce": "segreduce.cu",
           "blocksum": "blocksum.cu", "transpose": "transpose.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library, all nvcc processes at once.

    Returns {"seconds": wall time, "built": [names], "ptxas": {name: log}}.
    Each library is written to a temporary name and renamed into place, so
    concurrent processes never load a half-written file."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    logs = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building the kernels first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def kernel_info(name: str, *args: int) -> dict:
    """A main-path kernel of library `name` as the CUDA runtime reports it,
    through its `vegs_<name>_info(*args, res)` export: registers per
    thread, shared memory per block (bytes), resident blocks per SM, local
    (spilled) bytes per thread. Needs a card."""
    fn = getattr(load(name), f"vegs_{name}_info")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    res = (ctypes.c_int * 4)()
    check(fn(*args, res), f"vegs_{name}_info")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), res))
