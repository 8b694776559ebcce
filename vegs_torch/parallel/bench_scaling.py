"""Scaling benchmark: rays/s at each rank count (port of
vegs_tpu/parallel/bench_scaling.py).

`run` times the static data-parallel step (`train.train_step` with a
`comm`) with one camera a rank on an orbit around a seeded field;
`run_tile` times the tile-sharded render's forward and backward of ONE
image split over the ranks. Each rank count is one `launch.spawn` of that many ranks: NCCL, one
rank per card, on the card (a count above the cards is skipped, as the JAX
benchmark skips counts above its devices), unless the caller passes
`backend="gloo"`, which stages every collective through the host
("gloo-host") and lets ranks share a card. A gloo-host reading on one card
measures the sharded code, not scaling across cards. On the CPU
(`device="cpu"`) every count runs under gloo.

Usage: python -m vegs_torch.parallel.bench_scaling [--devices 1 2]
       [--mode dp|tile] [--backend nccl|gloo] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import geometry


def orbit_camera(height: int, width: int, theta: float, device,
                 distance: float = 4.0, fovx: float = 1.0,
                 fovy: float = 0.8):
    """A camera `distance` from the origin, turned by `theta` about y,
    looking at the field (the JAX tests' `make_camera(R=R_y(theta), t=(0,
    0, distance))`)."""
    from ..ops.projection import CameraParams

    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    view = geometry.world_to_view(R, np.array([0.0, 0.0, distance]))
    full = geometry.projection_matrix(0.01, 100.0, fovx, fovy) @ view
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    return CameraParams(viewmatrix=f32(view.T), projmatrix=f32(full.T),
                        campos=f32(np.linalg.inv(view)[:3, 3]),
                        tan_fovx=f32(np.tan(fovx / 2)),
                        tan_fovy=f32(np.tan(fovy / 2)),
                        height=height, width=width)


def _rank_device(rank: int, device_type: str, backend: str):
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, iters: int, dev) -> float:
    fn()
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def _dp_rank(rank, n, height, width, iters, device_type, backend, k_cap):
    from ..config import OptimizationParams
    from ..gaussians import DensifyStats, create_from_points
    from ..ops.rasterize import RasterizeConfig
    from .. import optim
    from ..train import TrainState, train_step
    from .mesh import make_mesh

    dev = _rank_device(rank, device_type, backend)
    D = dist.get_world_size()
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 8
    pts[:, 2] = np.abs(pts[:, 2]) + 2
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    field = create_from_points(pts, cols, device=dev)
    state = TrainState(field=field, opt=optim.adam_init(field),
                       stats=DensifyStats.zeros(field.capacity, dev), step=0)
    cam = orbit_camera(height, width, 2 * np.pi * rank / D, dev,
                       distance=10.0)
    gt = torch.zeros((3, height, width), device=dev)
    bg = torch.zeros(3, device=dev)
    opt_cfg, raster = OptimizationParams(), RasterizeConfig(k_cap=k_cap)
    comm = make_mesh().comm()
    sec = _timed(lambda: train_step(state, cam, gt, gt, 0.0, 3, bg,
                                    opt_cfg=opt_cfg, raster_cfg=raster,
                                    spatial_scale=8.0, comm=comm),
                 iters, dev)
    return {"sec_per_step": sec,
            "transport": make_mesh().comm().transport(dev)}


def _tile_rank(rank, n, height, width, iters, device_type, backend, k_cap):
    from ..ops.rasterize import RasterizeConfig
    from ..perf.refscale import random_gaussians
    from .gauss_sharded import shard_field_arrays
    from .tile_sharded import make_tile_mesh, make_tile_sharded_rasterize

    dev = _rank_device(rank, device_type, backend)
    mesh = make_tile_mesh(dist.get_world_size())
    rng = np.random.default_rng(0)
    arrs = [torch.from_numpy(x).to(dev) for x in random_gaussians(
        rng, n, (1.0, 8.0), 2.5, (0.02, 0.25), (0.2, 0.95))]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    sh = shard_field_arrays(mesh, *arrs, valid)
    means = sh[0].clone().requires_grad_(True)
    fn = make_tile_sharded_rasterize(
        mesh, orbit_camera(height, width, 0.0, dev, distance=0.0),
        RasterizeConfig(k_cap=k_cap))
    bg = torch.zeros(3, device=dev)

    def fwd_bwd():
        rgb = fn(means, *sh[1:], bg)[0]
        (rgb ** 2).mean().backward()
        means.grad = None

    return {"sec_per_step": _timed(fwd_bwd, iters, dev),
            "transport": mesh.comm().transport(dev)}


def _sweep(body, device_counts, n, height, width, iters, device, backend,
           k_cap, rays_of) -> dict:
    from .. import resolve_device
    from .launch import spawn

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    results = {}
    for nd in device_counts:
        if backend == "nccl" and nd > torch.cuda.device_count():
            continue
        with tempfile.TemporaryDirectory() as tmp:
            r = spawn(body, nd, n, height, width, iters, dev.type, backend,
                      k_cap, backend=backend,
                      init_file=Path(tmp) / "rendezvous")[0]
        r["rays_per_s"] = rays_of(nd) / r["sec_per_step"]
        results[nd] = r
    return results


def run(device_counts, n_gaussians: int = 100_000, height: int = 256,
        width: int = 512, iters: int = 4, device=None, backend=None,
        k_cap: int = 1 << 19) -> dict:
    """{D: {sec_per_step, rays_per_s, scaling_eff, transport}} of the DP
    step, one camera a rank (rays: D images a step)."""
    res = _sweep(_dp_rank, device_counts, n_gaussians, height, width, iters,
                 device, backend, k_cap, lambda nd: nd * height * width)
    base = res.get(device_counts[0], {}).get("rays_per_s")
    for nd, r in res.items():
        r["scaling_eff"] = (r["rays_per_s"] / (base * nd / device_counts[0])
                            if base else None)
    return res


def run_tile(device_counts, n_gaussians: int = 100_000, height: int = 256,
             width: int = 512, iters: int = 4, device=None, backend=None,
             k_cap: int = 1 << 19) -> dict:
    """{D: {sec_per_step, rays_per_s, speedup, transport}} of one image's
    tile-sharded forward and backward split over D ranks (the ideal is the
    same rays/s at 1/D of the memory; speedup against the smallest D)."""
    res = _sweep(_tile_rank, device_counts, n_gaussians, height, width,
                 iters, device, backend, k_cap, lambda nd: height * width)
    base = res.get(device_counts[0], {}).get("sec_per_step")
    for r in res.values():
        r["speedup"] = base / r["sec_per_step"] if base else None
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--mode", default="dp", choices=["dp", "tile"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    fn = run_tile if args.mode == "tile" else run
    print(json.dumps(fn(args.devices, device=args.device,
                        backend=args.backend), indent=2))
