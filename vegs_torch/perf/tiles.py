"""Tile-shape sweep at the bench workload: port of perf/r05_tiles.py.

Bigger tiles mean fewer boundary-crossing duplicates (a smaller K for every
O(K) stage: sorts, gathers, the segment reduce) at the cost of more pixels
per blend block and a coarser early exit. At 376x1408 and 500,000
Gaussians (r05:36-46, the scene of `refscale.build_scene`), for each tile
shape: k_cap sized as r05:54-66 does (`size_k_cap`), then `rasterize`
forward and backward of r05's loss, mean(rgb^2) + 0.01 mean(depth^2),
timed by CUDA events after a warm-up (`timing.cuda_ms`: the stream's time,
host gaps included, as r05's loop differencing timed its jitted loop), and
one JSON line a shape: the tile, k_cap, Mpix/s and ms, whether K4's gate
(`rasterize.SAT_MIN_SLOTS_PER_TILE`) is on at that k_cap, and each
kernel's launches in the timed calls (`calls`: with the one warm-up on the
card).

Run on the card:  python -m vegs_torch.perf.tiles [16x16 16x32 ...]
(default: 16x16 16x32 32x32 32x16, r05's order)
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .. import geometry, resolve_device
from ..ops import binning
from ..ops.projection import project
from ..ops.rasterize import (SAT_MIN_SLOTS_PER_TILE, RasterizeConfig,
                             rasterize)
from . import all_counters, launch_counts
from .refscale import build_scene, r512
from .timing import cuda_ms, device_line

H, W = 376, 1408
N = 500_000
K_CAP = 1 << 21
ITERS = 8
SHAPES = ((16, 16), (16, 32), (32, 32), (32, 16))


def size_k_cap(cam, arrays, tile_h: int, tile_w: int,
               cap: int = K_CAP) -> dict:
    """r05:54-66: bin at `cap`, take the padded need + 5% rounded up to
    512 (at most `cap`), bin again there, and if anything was dropped take
    25% more (rounded up to 512, at most `cap`). Returns {"need", "k_cap",
    "dropped"} (`dropped` at the first sized k_cap)."""
    means, quats, scales, opac, shs = arrays
    grid = binning.TileGrid.for_image(cam.height, cam.width, tile_h, tile_w)
    with torch.no_grad():
        p = project(means, geometry.cov6_from_scaling_rotation(scales, quats),
                    opac, shs, cam)

        def binned(k_cap):
            return binning.bin_gaussians(
                p.means2d, p.depths, p.radii_xy, grid, k_cap,
                conics=p.conics, opacities=p.opacities)

        need = int(binned(cap).tile_starts[-1])
        k_cap = min(cap, r512(need * 1.05))
        dropped = int(binned(k_cap).num_dropped)
    if dropped:
        k_cap = min(cap, (k_cap * 5 // 4 + 511) // 512 * 512)
    return {"need": need, "k_cap": k_cap, "dropped": dropped}


def size_shapes(cam, arrays, shapes=SHAPES) -> dict:
    """`size_k_cap` for each (tile_h, tile_w) of `shapes`."""
    return {(th, tw): size_k_cap(cam, arrays, th, tw) for th, tw in shapes}


def sweep(device=None, n: int = N, h: int = H, w: int = W, shapes=SHAPES,
          emit=None, scene=None, sized=None) -> list:
    """The sweep on `device` (the card unless device="cpu"): one dict a
    shape, each also passed to `emit` (default: printed as a JSON line).
    `scene` is a (cam, arrays) pair of `n` Gaussians at h x w already built
    (default: `build_scene`), `sized` the shapes' `size_shapes` on it
    (default: sized here). On the CPU the time is the host's ("cpu_ms"),
    never a device number."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = scene if scene is not None else build_scene(n, h, w, dev)
    sized = sized if sized is not None else size_shapes(cam, arrays, shapes)
    bg = torch.zeros(3, device=dev)
    leaves = [x.clone().requires_grad_(True) for x in arrays]
    counters = all_counters()
    rows = []
    for th, tw in shapes:
        cfg = RasterizeConfig(k_cap=sized[th, tw]["k_cap"], tile_h=th,
                              tile_w=tw)
        grid = binning.TileGrid.for_image(h, w, th, tw)

        def fwd_bwd(cfg=cfg):
            out = rasterize(*leaves, cam, bg=bg, config=cfg)
            loss = out.rgb.square().mean() + 0.01 * out.depth.square().mean()
            return torch.autograd.grad(loss, leaves)

        fwd_bwd()  # warm-up
        for c in counters.values():
            c.launches = 0
        row = {"tile": f"{th}x{tw}", "k_cap": cfg.k_cap,
               "need": sized[th, tw]["need"],
               "dropped_at_first_k_cap": sized[th, tw]["dropped"],
               "tiles": grid.num_tiles,
               "sat_gate_on": cfg.k_cap >= (SAT_MIN_SLOTS_PER_TILE
                                            * grid.num_tiles)}
        if dev.type == "cuda":
            ms = cuda_ms(fwd_bwd, iters=ITERS, warmup=1)
            row.update(ms=ms, mpixs=h * w / ms / 1e3, calls=ITERS + 1)
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fwd_bwd()
            row.update(cpu_ms=(time.perf_counter() - t0) / ITERS * 1e3,
                       calls=ITERS)
        row["launches"] = launch_counts(counters)
        row["card"] = card
        emit(**row)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    shapes = (tuple(tuple(int(x) for x in s.split("x")) for s in argv)
              or SHAPES)
    sweep(shapes=shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
