"""The sharded paths on the port's kernels at one rank: port of
perf/r07_shard_pallas.py.

200,000 Gaussians placed as r07_shard_pallas.py:65-76 places them (the
bench scene's draws, `refscale.build_scene`), 376x1408, k_cap 2^20 (the
sat-cull gate stays off). In a process group of one rank -- NCCL on the
card, gloo on the CPU; `run` starts it when none exists and ends what it
started:

1. the tile-sharded render at D = 1 (`make_tile_sharded_rasterize`)
   against the unsharded `rasterize`, with f32 and bf16 payloads. The
   port's sharded renders equal `rasterize` to the bit at every D, so the
   bit is held where the script held a PSNR above 45 dB (:107); the PSNR
   is reported beside it. (The JAX package's tile-sharded function raises
   a NameError at D = 1, vegs_tpu/parallel/tile_sharded.py:167-221.)
2. forward and backward of mean(rgb^2) through both paths: ms (stream and
   the card's own, `timing.measure`) and Mpix/s by the stream's ms;
3. the fully sharded trainer's step (`make_tp_train_step`) at D = 1 on
   the first 50,000 means with seeded colours (capacity 2^16, k_cap 2^18,
   default `OptimizationParams`, spatial scale 6, zero ground truth and
   normals; :126-169): the first call's seconds, one step's ms, and the
   ms a step of 4 chained steps, with the losses.

The forward and backward launch K1, K2 and K3; the TP steps launch them
too.

Run on the card:  python -m vegs_torch.perf.shard_check
"""

from __future__ import annotations

import json
import math
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.rasterize import RasterizeConfig, rasterize
from .refscale import SEED, build_scene
from .timing import device_line, measure

H, W = 376, 1408
N = 200_000
K_CAP = 1 << 20
TIMING_ITERS = 4          # r07_shard_pallas.py:35
TP_N, TP_CAPACITY, TP_K_CAP = 50_000, 1 << 16, 1 << 18
TP_SCALE = 6.0
TP_CHAINED = 4


def psnr(a, b) -> float:
    """PSNR (dB) of b against a, both in [0, 1]; 120 dB when equal (the
    script's 1e-12 floor on the MSE)."""
    mse = float(((a - b).double() ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-12))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class one_rank:
    """A process group of one rank for the `with` block (NCCL on the card,
    gloo on the CPU, over a file:// store in a temporary directory), or
    the group that exists."""

    def __init__(self, dev):
        self.dev, self.tmp = dev, None

    def __enter__(self):
        if not dist.is_initialized():
            self.tmp = tempfile.TemporaryDirectory()
            dist.init_process_group(
                "nccl" if self.dev.type == "cuda" else "gloo",
                init_method=f"file://{self.tmp.name}/rdv", world_size=1,
                rank=0)
        return self

    def __exit__(self, *exc):
        if self.tmp is not None:
            dist.destroy_process_group()
            self.tmp.cleanup()


def renders(cam, arrays, bg, k_cap: int = K_CAP) -> dict:
    """Step 1: per payload dtype, the unsharded and the D = 1 tile-sharded
    render (rgb, depth, alpha), whether each is equal to the bit, the
    PSNR, the largest and mean |d| of rgb, the instances each dropped."""
    from ..parallel.tile_sharded import (make_tile_mesh,
                                         make_tile_sharded_rasterize)

    means = arrays[0]
    valid = torch.ones(means.shape[0], dtype=torch.bool, device=means.device)
    mesh = make_tile_mesh(1)
    out = {}
    with torch.no_grad():
        for pdt in ("f32", "bf16"):
            cfg = RasterizeConfig(k_cap=k_cap, payload_dtype=pdt)
            base = rasterize(*arrays, cam, bg=bg, config=cfg)
            rgb, depth, alpha, dropped = make_tile_sharded_rasterize(
                mesh, cam, cfg)(*arrays, valid, bg)
            d = (base.rgb - rgb).abs()
            out[pdt] = {
                "equal": {k: bool(torch.equal(getattr(base, k), x))
                          for k, x in (("rgb", rgb), ("depth", depth),
                                       ("alpha", alpha))},
                "psnr_db": psnr(base.rgb, rgb),
                "max_abs": float(d.max()), "mean_abs": float(d.mean()),
                "dropped": {"unsharded": int(base.num_dropped),
                            "sharded": int(dropped)}}
    return out


def fwd_bwd(cam, arrays, bg, dev, k_cap: int = K_CAP,
            iters: int = TIMING_ITERS, warmup: int = 3) -> dict:
    """Step 2: mean(rgb^2) and its gradient with respect to the means
    through the unsharded and the D = 1 tile-sharded path, timed; Mpix/s
    by the stream's ms."""
    from ..parallel.tile_sharded import (make_tile_mesh,
                                         make_tile_sharded_rasterize)

    means, rest = arrays[0], arrays[1:]
    valid = torch.ones(means.shape[0], dtype=torch.bool, device=dev)
    cfg = RasterizeConfig(k_cap=k_cap)
    shard_fn = make_tile_sharded_rasterize(make_tile_mesh(1), cam, cfg)
    leaf = means.clone().requires_grad_(True)

    def base():
        out = rasterize(leaf, *rest, cam, bg=bg, config=cfg)
        loss = out.rgb.square().mean()
        return loss, torch.autograd.grad(loss, leaf)[0]

    def shard():
        loss = shard_fn(leaf, *rest, valid, bg)[0].square().mean()
        return loss, torch.autograd.grad(loss, leaf)[0]

    out = {}
    for name, fn in (("unsharded", base), ("tile_sharded", shard)):
        loss, grad = fn()
        t = measure(fn, dev, iters, warmup)
        out[name] = {"loss": float(loss.detach()), "grad_finite": bool(
            torch.isfinite(grad).all()), **t}
        if "ms" in t:   # the card's stream; no rate from a host clock
            out[name]["mpixs"] = cam.height * cam.width / t["ms"] / 1e3
    return out


def tp_step(cam, means, rng, dev, n: int = TP_N,
            capacity: int = TP_CAPACITY, k_cap: int = TP_K_CAP,
            chained: int = TP_CHAINED) -> dict:
    """Step 3: the D = 1 fully sharded trainer's step on the first `n`
    means with colours drawn from `rng` (r07_shard_pallas.py:145-146):
    the first call's seconds, one step's ms, the ms a step of `chained`
    steps, the losses."""
    from .. import gaussians, optim
    from ..config import OptimizationParams
    from ..parallel.tile_sharded import make_tile_mesh
    from ..parallel.tp_trainer import make_tp_train_step, shard_train_state

    mesh = make_tile_mesh(1)
    pts = means[:n].cpu().numpy()
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    field = gaussians.create_from_points(pts, cols, capacity=capacity,
                                         device=dev)
    state = shard_train_state(mesh, field, optim.adam_init(field),
                              gaussians.DensifyStats.zeros(capacity, dev))
    step_fn = make_tp_train_step(mesh, OptimizationParams(),
                                 RasterizeConfig(k_cap=k_cap), TP_SCALE, cam)
    gt = torch.zeros((3, cam.height, cam.width), device=dev)
    normal = torch.zeros_like(gt)
    bg = torch.zeros(3, device=dev)
    f, o, s = state

    def step(i):
        nonlocal f, o, s
        f, o, s, nxt, m = step_fn(f, o, s, i, cam, gt, normal, 3, bg)
        return nxt, m

    t0 = time.perf_counter()
    i, m = step(0)
    loss0 = float(m["loss"])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    i, m = step(i)
    loss1 = float(m["loss"])
    one_ms = (time.perf_counter() - t0) * 1e3
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(chained):
        i, m = step(i)
    loss_last = float(m["loss"])   # one read after the chained steps
    chained_ms = (time.perf_counter() - t0) * 1e3 / chained
    return {"n": n, "capacity": capacity, "k_cap": k_cap,
            "losses": [loss0, loss1, loss_last], "first_call_s": first_s,
            "one_step_ms": one_ms, "chained_ms_per_step": chained_ms,
            "chained": chained, "num_dropped": int(m["num_dropped"])}


def run(device=None, n: int = N, h: int = H, w: int = W, k_cap: int = K_CAP,
        iters: int = TIMING_ITERS, warmup: int = 3, tp=None,
        emit=None) -> dict:
    """Steps 1-3 (see the module note) on `device` (the card unless
    device="cpu"); `tp` overrides `tp_step`'s sizes. One dict a step to
    `emit` (default: a JSON line). Raises unless the D = 1 sharded render
    equals `rasterize` to the bit with nothing dropped and every loss and
    gradient is finite."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    rng = np.random.default_rng(SEED)
    cam, arrays = build_scene(n, h, w, dev, rng=rng)
    bg = torch.zeros(3, device=dev)
    with one_rank(dev):
        res = {"renders": renders(cam, arrays, bg, k_cap)}
        emit(probe="shard_check", step="renders", **res["renders"],
             card=card)
        res["fwd_bwd"] = fwd_bwd(cam, arrays, bg, dev, k_cap, iters, warmup)
        emit(probe="shard_check", step="fwd_bwd", **res["fwd_bwd"], card=card)
        res["tp"] = tp_step(cam, arrays[0], rng, dev, **(tp or {}))
        emit(probe="shard_check", step="tp", **res["tp"], card=card)
    for pdt, r in res["renders"].items():
        if not all(r["equal"].values()) or any(r["dropped"].values()):
            raise AssertionError(f"{pdt}: the D = 1 tile-sharded render "
                                 f"differs from rasterize: {r}")
    if not (all(x["grad_finite"] and np.isfinite(x["loss"])
                for x in res["fwd_bwd"].values())
            and np.isfinite(res["tp"]["losses"]).all()):
        raise AssertionError(f"a loss or gradient is not finite: {res}")
    res["card"] = card
    return res


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
