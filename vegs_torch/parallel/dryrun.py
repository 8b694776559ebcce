"""The multi-device dry run (port of __graft_entry__.dryrun_multichip): on
`n_devices` ranks, ONE full data-parallel training step (the full model:
2 box slots with a pose and residual per rank, densify statistics, the
normal loss) and ONE fully sharded (TP) step, at the JAX dry run's shapes
(32x128, 256 points in 512 rows, boxes of 48 points in 64 rows).

    python -m vegs_torch.parallel.dryrun [n_devices]   # on the card(s)

On the card each rank takes one card (NCCL); `device="cpu"` runs gloo
ranks on the CPU.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _rank(rank: int, device_type: str) -> dict:
    from .. import optim
    from ..boxmodel import BoxDeltas
    from ..config import OptimizationParams, VegsConfig
    from ..gaussians import DensifyStats, create_from_points
    from ..ops.rasterize import RasterizeConfig
    from ..train import BoxStep, TrainState, train_step
    from .bench_scaling import orbit_camera
    from .mesh import make_mesh
    from .tile_sharded import make_tile_mesh
    from .tp_trainer import make_tp_train_step, shard_train_state

    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device(device_type))
    D = dist.get_world_size()
    comm = make_mesh().comm()
    h, w = 32, 128
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(256, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    field = create_from_points(pts, cols, capacity=512, device=dev)
    state = TrainState(field=field, opt=optim.adam_init(field),
                       stats=DensifyStats.zeros(field.capacity, dev), step=0)
    bpts = rng.uniform(-0.45, 0.45, (2, 48, 3)).astype(np.float32)
    boxes = []
    for i in range(2):
        bf = create_from_points(bpts[i], capacity=64, scale_clip=(1e-7, 1e-4),
                                device=dev)
        b2w = torch.eye(4, device=dev)
        b2w[2, 3] = 0.5
        d = BoxDeltas.identity(dev)
        boxes.append(BoxStep(field=bf, opt=optim.adam_init(bf),
                             stats=DensifyStats.zeros(64, dev), box2world=b2w,
                             deltas=d,
                             delta_opt=optim.adam_init(d.as_dict())))
    cam = orbit_camera(h, w, 2 * np.pi * rank / D, dev)
    gt = torch.zeros((3, h, w), device=dev)
    cfg = VegsConfig()
    cfg.box.boxmodel_lr, cfg.box.boxmodel_lambda_reg = 1e-3, 1e-3
    raster = RasterizeConfig(k_cap=1 << 12)
    state, m, _ = train_step(
        state, cam, gt, gt, 1.0, 3, torch.zeros(3, device=dev),
        opt_cfg=OptimizationParams(), raster_cfg=raster, spatial_scale=4.0,
        boxes=boxes, box_cfg=cfg.box, comm=comm)
    loss = float(m["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"DP step: loss {loss}, step {state.step}")
    if float(state.stats.denom.sum()) <= 0:
        raise AssertionError("densify stats did not accumulate")

    tp_mesh = make_tile_mesh(D)
    field = create_from_points(pts, cols, capacity=512, device=dev)
    sf, so, ss = shard_train_state(tp_mesh, field, optim.adam_init(field),
                                   DensifyStats.zeros(512, dev))
    cam0 = orbit_camera(h, w, 0.0, dev)
    tp = make_tp_train_step(tp_mesh, OptimizationParams(), raster, 4.0, cam0,
                            use_normal_loss=True)
    sf, so, ss, _, tm = tp(sf, so, ss, 0, cam0, gt, gt, 3,
                           torch.zeros(3, device=dev))
    tp_loss = float(tm["loss"])
    if not np.isfinite(tp_loss) or sf.capacity != 512 // D:
        raise AssertionError(f"TP step: loss {tp_loss}, rows {sf.capacity}")
    return {"loss": loss, "tp_loss": tp_loss,
            "transport": comm.transport(dev)}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dry run on n_devices ranks; returns rank 0's losses."""
    from .. import resolve_device
    from .launch import spawn

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        r = spawn(_rank, n_devices, dev.type, backend=backend,
                  init_file=Path(tmp) / "rendezvous")[0]
    print(f"dryrun_multichip({n_devices}): loss={r['loss']:.4f} "
          f"tp loss={r['tp_loss']:.4f} OK ({r['transport']}: full step with "
          "2 box slots, densify stats, normal loss; fully sharded step)")
    return r


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    dryrun_multichip(n)
