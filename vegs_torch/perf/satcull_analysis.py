"""What a tile-level saturation cull could prune at the reference's scale:
port of perf/r09_satcull_analysis.py.

At the 2,233,571-Gaussian bench scene (376x1408, `refscale.build_scene`),
on the (tile, depth)-sorted raw instance stream (`bin_raw` at 2^23 - 512
slots, the ellipse cull on, the compact pre-cull off, r09:62-65):

- counted: the instances whose whole-tile minimum alpha, op exp(-qmax/2)
  over the tile's four corners clamped at 0.99, is at least 1/255;
- the conservative tile-saturation cull (T_EPS 1e-4): instance i is culled
  when the product over the counted instances before it in its tile of
  (1 - alpha_min) is below T_EPS, which by the blend's per-pixel stop
  rule makes its contribution exactly zero at every pixel; kept per tile;
- the per-pixel oracle over 120 sampled tiles (numpy seed 1): the share of
  their instances that contribute to no pixel of the tile (the cull's
  upper bound), and the suffix cull (every instance after the last pixel's
  crossing), exact and at 256-slot granularity.

All in float64, in r09's operation order. Beside them, on the same frame
at the sized capacities (`refscale.size_caps`), what the main path prunes
today: the share of the real instances K4's counts drop
(`satcull.satcount_gathered`), and the share of warp-instance pairs K1's
per-warp footprint cull skips (`blend_cuda.blend_check`, on the card).

Run on the card:  python -m vegs_torch.perf.satcull_analysis
(r09's VEGS_SAT_N, VEGS_TILE_H and VEGS_TILE_W are the arguments `n`,
`tile_h` and `tile_w` of `run`.)
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from .. import resolve_device
from ..ops import binning, blend_cuda
from ..ops.rasterize import RasterizeConfig, stage
from .binning_probes import projected
from .refscale import build_scene, size_caps
from .timing import device_line

H, W = 376, 1408
N_REF = 2_233_571
K_CAP = (1 << 23) - 512
T_EPS = 1e-4
SAMPLE_TILES, SAMPLE_SEED = 120, 1
F64 = torch.float64


def analyse(m2d, depths, radii_xy, conics, opacities, grid: binning.TileGrid,
            k_cap: int = K_CAP) -> dict:
    """r09:67-163 on projected arrays: the counted and conservatively
    culled instances, kept per tile, and the sampled oracle and suffix
    culls, as exact counts (and shares)."""
    rb = binning.bin_raw(m2d, depths, radii_xy, grid, k_cap, conics=conics,
                         opacities=opacities, compact=False)
    num_real = int(rb.num_real)
    keys = rb.key_sorted[:num_real].long()
    gidx = rb.gidx_sorted[:num_real].long()
    raw_starts = rb.raw_starts.long()
    con = conics.to(F64)
    op = opacities.reshape(-1).to(F64)
    tile_id = keys >> grid.tile_shift
    tx, ty = tile_id % grid.ntx, tile_id // grid.ntx

    mx, my = m2d[gidx, 0].to(F64), m2d[gidx, 1].to(F64)
    a, b, c = con[gidx, 0], con[gidx, 1], con[gidx, 2]
    lx = tx * grid.tile_w - mx
    hx = lx + (grid.tile_w - 1)
    ly = ty * grid.tile_h - my
    hy = ly + (grid.tile_h - 1)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    qmax = torch.maximum(torch.maximum(q(lx, ly), q(lx, hy)),
                         torch.maximum(q(hx, ly), q(hx, hy)))
    alpha_min = torch.clamp(op[gidx] * torch.exp(-0.5 * qmax), max=0.99)
    counted = alpha_min >= 1.0 / 255.0
    lg = torch.where(counted, torch.log1p(-alpha_min),
                     torch.zeros((), dtype=F64, device=m2d.device))
    cum = torch.cumsum(lg, dim=0)
    starts, ends = raw_starts[:-1], raw_starts[1:]
    per_tile = torch.clamp(ends - starts, min=0)
    tile_of_slot = torch.repeat_interleave(
        torch.arange(grid.num_tiles, device=m2d.device), per_tile)
    cum_at_start = torch.cat([cum.new_zeros(1), cum])[starts[tile_of_slot]]
    s_excl = (cum - lg) - cum_at_start
    culled = s_excl < math.log(T_EPS)
    kept_per_tile = torch.bincount(tile_of_slot, weights=(~culled).to(F64),
                                   minlength=grid.num_tiles)
    res = {"real": num_real, "tiles": grid.num_tiles,
           "counted": int(counted.sum()), "culled": int(culled.sum()),
           "median_kept_per_tile": float(np.median(kept_per_tile.cpu().numpy())),
           "median_per_tile": float(np.median((ends - starts).cpu().numpy()))}

    starts_h, ends_h = starts.cpu().numpy(), ends.cpu().numpy()
    rng = np.random.default_rng(SAMPLE_SEED)
    tiles = rng.choice(np.flatnonzero((ends_h - starts_h) > 0),
                       size=min(SAMPLE_TILES, grid.num_tiles), replace=False)
    oracle_cullable = oracle_total = cons = suffix_exact = suffix_chunk = 0
    for t in tiles.tolist():
        idx = torch.arange(int(starts_h[t]), int(ends_h[t]), device=m2d.device)
        n_i = len(idx)
        ox, oy = (t % grid.ntx) * grid.tile_w, (t // grid.ntx) * grid.tile_h
        py, px = torch.meshgrid(
            torch.arange(oy, oy + grid.tile_h, device=m2d.device),
            torch.arange(ox, ox + grid.tile_w, device=m2d.device),
            indexing="ij")
        dx = px.reshape(-1)[None, :] - mx[idx][:, None]
        dy = py.reshape(-1)[None, :] - my[idx][:, None]
        power = (-0.5 * (a[idx][:, None] * dx * dx + c[idx][:, None] * dy * dy)
                 - b[idx][:, None] * dx * dy)
        alpha = torch.clamp(op[gidx[idx]][:, None] * torch.exp(power),
                            max=0.99)
        valid = (power <= 0) & (alpha >= 1 / 255)
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
        L = torch.log1p(-alpha)
        T = torch.exp(torch.cumsum(L, dim=0) - L)
        crossing = (T * (1 - alpha) < T_EPS) & (alpha > 0)
        ci = crossing.to(torch.int64)
        stopped_before = (torch.cumsum(ci, dim=0) - ci) > 0
        include = valid & ~stopped_before & ~crossing
        oracle_cullable += int((~include.any(dim=1)).sum())
        oracle_total += n_i
        cons += int(culled[idx].sum())
        first = torch.where(crossing.any(dim=0), ci.argmax(dim=0),
                            torch.full_like(ci[0], n_i))
        dead_after = int(first.max()) + 1 if n_i else 0
        suffix_exact += max(n_i - dead_after, 0)
        suffix_chunk += n_i - min(-(-dead_after // 256) * 256, n_i)
    res.update(sampled_tiles=len(tiles), oracle_total=oracle_total,
               oracle_cullable=oracle_cullable, conservative_in_sample=cons,
               suffix_exact=suffix_exact, suffix_256=suffix_chunk)
    res.update(counted_share=res["counted"] / max(num_real, 1),
               culled_share=res["culled"] / max(num_real, 1),
               oracle_share=oracle_cullable / max(oracle_total, 1),
               conservative_in_sample_share=cons / max(oracle_total, 1),
               suffix_exact_share=suffix_exact / max(oracle_total, 1),
               suffix_256_share=suffix_chunk / max(oracle_total, 1))
    return res


def main_path_prune(cam, arrays, tile_h: int, tile_w: int) -> dict:
    """On the same frame at the sized capacities: the share of the real
    instances K4's counts drop, and (on the card) the share of
    warp-instance pairs K1's footprint cull skips."""
    caps = size_caps(cam, arrays, tile_h, tile_w, sat=True)
    cfg = RasterizeConfig(k_cap=caps.k_cap, k_pad=caps.k_pad, tile_h=tile_h,
                          tile_w=tile_w, sat_cull=True, forward_only=True)
    with torch.no_grad():
        st = stage(*arrays, cam, config=cfg)
        rb = st.rb
        raw_counts = rb.raw_starts[1:] - rb.raw_starts[:-1]
        kept = int(torch.minimum(st.sat_counts, raw_counts).sum())
        real = int(rb.num_real)
        out = {"k_cap": caps.k_cap, "k_pad": caps.k_pad, "real": real,
               "k4_kept": kept, "k4_pruned_share": 1.0 - kept / max(real, 1)}
        if st.payload_f32.device.type == "cuda":
            g = st.grid
            _, _, counts = blend_cuda.blend_check(
                st.payload_f32, st.payload_aux, st.binned.tile_starts, g,
                g.padded_height, g.padded_width, cull=True)
            out["k1_cull_skipped_share"] = counts["skipped_share"]
        else:
            out["k1_cull_skipped_share"] = None  # the counts need the card
    return out


def run(device=None, n: int = N_REF, h: int = H, w: int = W,
        tile_h: int = 16, tile_w: int = 16, emit=None) -> dict:
    """The analysis and the main path's prune (see the module note) on
    `device` (the card unless device="cpu"); one JSON line each."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    grid = binning.TileGrid.for_image(h, w, tile_h, tile_w)
    with torch.no_grad():
        res = analyse(*projected(cam, arrays), grid)
    emit(analysis="satcull potential", n=n, tile=f"{tile_h}x{tile_w}",
         **res, card=card)
    prune = main_path_prune(cam, arrays, tile_h, tile_w)
    emit(analysis="main path prune", n=n, tile=f"{tile_h}x{tile_w}", **prune,
         card=card)
    return {"analysis": res, "prune": prune, "card": card}


if __name__ == "__main__":
    run()
