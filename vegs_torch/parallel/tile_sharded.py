"""Tile-axis sharded rasterization with an all-to-all splat exchange (port
of vegs_tpu/parallel/tile_sharded.py).

One mesh axis plays both roles:
  * front end -- each rank holds a GAUSSIAN row block (N/D rows):
    projection, payload build, tile expansion, cull and the (tile, depth)
    sort run on N/D-proportional data;
  * splat exchange -- the image's tile rows are block-sharded on the same
    axis (rank d owns tile rows [d nty/D, (d+1) nty/D)). The local stream
    is sorted by tile, so the instances bound for each rank form contiguous
    ranges; they are cut into buckets of k_ex slots and delivered with one
    all-to-all (`comm.all_to_all`, whose backward is the reverse exchange);
  * back end -- each rank stable-sorts what it received (a merge of D
    sorted runs), lays it out in the padded per-tile layout and blends
    (K1; K2 in the backward) only the tiles of its own rows.

The per-Gaussian payload expansion is `GatherExpand` on the raw-slot order
of the local stream (`order_raw`), so its backward is kernel K3 as on the
single-device path.

Ties in the quantized (tile, depth) keys resolve to the ascending global
Gaussian index, as in the single-device path: ranks hold contiguous row
blocks, the exchange keeps source order and both sorts are stable. So the
image equals `ops.rasterize`'s to the bit.

What the port does not copy:
  * the JAX package's D = 1 branch (:167-221) never defines `me` and
    raises at trace time; here the general path runs at every D, with
    `me` the rank;
  * the JAX package blends a shard-local grid of nty/D tile rows after
    shifting each received splat's y by -me * hp_loc (:221-222). In
    float32 that shift is not exact for a splat whose mean lies above
    y_off / 2 (mean_y - y_off rounds), and the blend's dy = py - mean_y
    then differs in the last bit from the single-device image. The port
    lays the received splats out on the full tile grid instead -- every
    tile outside this rank's rows is empty -- and keeps this rank's rows of
    K1's output, so no coordinate moves. The empty tiles' blocks exit at
    once; the output is one full-height image per rank (12 float32
    channels, 25 MB at 376x1408).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import geometry
from ..ops import binning, blend_ref
from ..ops.binning import PAD_ALIGN, SENTINEL, TileGrid
from ..ops.projection import CameraParams, project
from ..ops.rasterize import (GatherExpand, RasterizeConfig,
                             _resolve_backend, assemble_dense_payload,
                             build_payload)
from .comm import Comm, all_gather, all_to_all, pmax, psum
from .mesh import Mesh, make_mesh

TILE_AXIS = "shard"
I32 = torch.int32


class _TakeRows(torch.autograd.Function):
    """src's rows at `idx` (dim 0); an index equal to len(src) reads a zero
    row. The real indices are unique, so the backward copies each row's
    cotangent back (`index_copy_`) where autograd's own backward of the
    gather would accumulate, and spend most of its time on the hundreds
    of thousands of padding slots that share the zero row (the JAX
    package's `concatenate(..)[idx]` transposes to a scatter-add)."""

    @staticmethod
    def forward(ctx, src, idx):
        n = src.shape[0]
        ctx.save_for_backward(idx)
        ctx.n = n
        return torch.cat([src, src.new_zeros((1,) + src.shape[1:])])[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        real = idx < ctx.n
        out = g.new_zeros((ctx.n,) + g.shape[1:])
        out.index_copy_(0, idx[real], g[real])
        return out, None


def take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of src, len(src) reading zeros; the real indices must be
    unique (they are: every gather of this module moves each instance to
    one slot)."""
    return _TakeRows.apply(src, idx)


def make_tile_mesh(n_devices: int) -> Mesh:
    return make_mesh(n_devices, TILE_AXIS)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TilePlan(NamedTuple):
    """Static shard geometry of one (camera, axis size, config)."""
    ndev: int
    grid: TileGrid
    nty_loc: int
    tiles_loc: int
    hp_loc: int
    wp: int
    k_loc: int
    k_ex: int
    r_total: int
    k_blend: int
    aux_dtype: object


def make_tile_plan(ndev: int, cam: CameraParams, config: RasterizeConfig,
                   k_exch: Optional[int] = None) -> TilePlan:
    """The grid's tile rows rounded up to a multiple of ndev; each rank's
    raw capacity k_loc = k_cap / ndev (512-aligned, >= PAD_ALIGN), bucket
    capacity k_ex (default k_loc: lossless), D * k_ex received slots and a
    padded layout of k_blend slots."""
    base = TileGrid.for_image(cam.height, cam.width, config.tile_h,
                              config.tile_w)
    nty = _round_up(base.nty, ndev)
    grid = TileGrid(config.tile_h, config.tile_w, base.ntx, nty)
    if grid.num_tiles > binning.MAX_TILES:
        raise ValueError(f"{grid.num_tiles} tiles exceed {binning.MAX_TILES}")
    nty_loc = nty // ndev
    tiles_loc = nty_loc * grid.ntx
    k_loc = _round_up(max(config.k_cap // ndev, PAD_ALIGN), 512)
    k_ex = k_loc if k_exch is None else _round_up(k_exch, 8)
    r_total = ndev * k_ex
    return TilePlan(
        ndev=ndev, grid=grid, nty_loc=nty_loc, tiles_loc=tiles_loc,
        hp_loc=nty_loc * grid.tile_h, wp=grid.ntx * grid.tile_w,
        k_loc=k_loc, k_ex=k_ex, r_total=r_total,
        k_blend=_round_up(r_total + tiles_loc * PAD_ALIGN, 512),
        aux_dtype=(torch.bfloat16 if config.payload_dtype == "bf16"
                   else torch.float32))


def tile_render_local(plan: TilePlan, cam: CameraParams,
                      config: RasterizeConfig, sh_degree: int, comm: Comm,
                      means, quats, scales, opac, shs, valid,
                      means2d_offset=None, record: Optional[dict] = None):
    """This rank's tile rows rendered from its Gaussian row block. Returns
    (out_local [12, hp_loc, wp], proj (this block's projection: radii and
    means2d for the densify statistics), (dropped, needed, needed_exch)):
    dropped sums capacity losses over the axis; needed is the largest
    local raw need times ndev, in the global k_cap units the capacity
    policy compares; needed_exch the largest bucket anywhere, the smallest
    lossless k_exch. `record`, when given, receives the exchange's bucket
    sizes, the kernels' inputs and the tensors their gradients are taken
    at: `blend_args` (K1), `blend_out` (the blend's output, K2's cotangent
    is taken there), `gather_out` (the expanded payload, K3's cotangents),
    `order_raw`, `ends`, and `pay_rows` and `gidx` (what the expansion
    gathers)."""
    ndev, grid = plan.ndev, plan.grid
    k_loc, k_ex, r_total = plan.k_loc, plan.k_ex, plan.r_total
    if comm.size != ndev:
        raise ValueError(f"plan for {ndev} ranks on an axis of {comm.size}")
    backend = _resolve_backend(config, means.device)
    dev = means.device

    # -- local front end: project and build the payload on the row block --
    cov6 = geometry.cov6_from_scaling_rotation(scales, quats)
    proj = project(means, cov6, opac, shs, cam, sh_degree=sh_degree,
                   valid=valid, means2d_offset=means2d_offset,
                   clamp_radius=config.clamp_radius)
    quat_n = geometry.quat_standardize(geometry.quat_normalize(quats))
    pay_f32, pay_aux = build_payload(proj, quat_n, scales, plan.aux_dtype)
    compact = (None if config.cull_compact == "auto"
               else bool(config.cull_compact))
    rb = binning.bin_raw(
        proj.means2d.detach(), proj.depths.detach(), proj.radii_xy, grid,
        k_loc, conics=proj.conics.detach(),
        opacities=proj.opacities.detach(), compact=compact)

    # Per-Gaussian -> per-instance expansion in sorted-stream order; the
    # backward (K3) reads each raw slot's cotangent at its sorted position
    # (order_raw, the inverse of the sort's permutation).
    order_raw = torch.empty(k_loc, dtype=I32, device=dev)
    order_raw[rb.rawslot_sorted.long()] = torch.arange(k_loc, dtype=I32,
                                                       device=dev)
    ends_l = torch.clamp(rb.cum, max=k_loc)
    ends = torch.cat([ends_l, ends_l[-1:]])
    st_pf, st_pa = GatherExpand.apply(
        F.pad(pay_f32, (0, 0, 0, 1)), F.pad(pay_aux, (0, 0, 0, 1)),
        rb.gidx_sorted, order_raw, ends)           # [8, k_loc], [16, k_loc]

    # -- cut the sorted stream into destination buckets -----------------
    bounds = torch.arange(ndev + 1, device=dev) * plan.tiles_loc
    bstart = rb.raw_starts[bounds]                               # [D+1]
    bucket_sizes = bstart[1:] - bstart[:-1]
    dropped_exch = torch.clamp(bucket_sizes - k_ex, min=0).sum()
    needed_exch = pmax(bucket_sizes.max(), comm)
    j = torch.arange(k_ex, dtype=I32, device=dev)
    idx = bstart[:-1, None] + j[None, :]                         # [D, k_ex]
    ok = (idx < bstart[1:, None]).reshape(-1)
    # empty slots read a zero row (`take_rows`)
    idx_safe = torch.where(ok, idx.reshape(-1), k_loc).long()
    keys_b = torch.where(
        ok, rb.key_sorted[torch.clamp(idx.reshape(-1), max=k_loc - 1).long()],
        SENTINEL)
    pf_b = take_rows(st_pf.T, idx_safe)                          # [D*k_ex, 8]
    pa_b = take_rows(st_pa.T, idx_safe)                          # [D*k_ex, 16]

    # -- the exchange: one all-to-all per table ----------------------------
    keys_r = all_to_all(keys_b, comm)
    pf_r = all_to_all(pf_b, comm)
    pa_r = all_to_all(pa_b, comm)

    # -- local back end: merge the received runs, lay them out on the full
    # grid (only this rank's tiles are non-empty), blend ------------------
    me = comm.index
    key_sorted, recv_sorted = torch.sort(keys_r, stable=True)
    queries = (torch.arange(grid.num_tiles + 1, dtype=I32, device=dev)
               << grid.tile_shift)
    raw_starts = torch.searchsorted(key_sorted, queries, side="left").to(I32)
    carry, keys_pad, tile_starts, _ = binning.pad_relayout(
        key_sorted, recv_sorted.to(I32), raw_starts, grid.num_tiles,
        plan.k_blend, dummy=r_total, want_keys=(backend == "dense"))
    carry = carry.long()
    pf_pad = take_rows(pf_r, carry)                              # [k_blend, 8]
    pa_pad = take_rows(pa_r, carry)                              # [k_blend, 16]
    hp, wp = grid.padded_height, grid.padded_width
    if backend == "dense":
        out = blend_ref.blend_dense(assemble_dense_payload(pf_pad, pa_pad),
                                    keys_pad, tile_starts, grid, hp, wp)
    else:
        from ..ops import blend_cuda

        pf_k, pa_k = pf_pad.T.contiguous(), pa_pad.T.contiguous()
        if record is not None:
            record["blend_args"] = (pf_k.detach(), pa_k.detach(),
                                    tile_starts, grid, hp, wp)
        out = blend_cuda.BlendFn.apply(pf_k, pa_k, tile_starts, grid, hp, wp)
    out_loc = out[:, me * plan.hp_loc:(me + 1) * plan.hp_loc]
    if record is not None:
        record.update(bucket_sizes=bucket_sizes, order_raw=order_raw,
                      ends=ends, blend_out=out, gather_out=(st_pf, st_pa),
                      pay_rows=F.pad(pay_f32, (0, 0, 0, 1)).detach(),
                      gidx=rb.gidx_sorted)

    dropped = psum(rb.total - rb.num_raw + dropped_exch, comm)
    # k_loc = k_cap / ndev, so the worst rank's raw need times ndev is the
    # smallest global k_cap that admits every instance (saturating: a
    # worst rank near 2^31 / ndev must not wrap)
    needed = torch.clamp(pmax(rb.total, comm),
                         max=(2**31 - 1) // max(ndev, 1)) * ndev
    return out_loc, proj, (dropped, needed, needed_exch)


def make_tile_sharded_rasterize(mesh: Mesh, cam: CameraParams,
                                config: RasterizeConfig, sh_degree: int = 3,
                                k_exch: Optional[int] = None):
    """fn(means, quats, scales, opac, shs, valid, bg) -> (rgb [3, H, W],
    depth [1, H, W], alpha [1, H, W], dropped) with per-Gaussian inputs
    this rank's row block and the blend sharded over tile rows; the rows
    are all-gathered, so every rank returns the whole image (and a loss
    every rank takes of it gets D copies of each row's cotangent back).

    `config.k_cap` is the GLOBAL instance capacity (k_cap / D per rank);
    `k_exch` the per-(source, destination) bucket capacity (default the
    full local capacity: lossless)."""
    comm = mesh.comm()
    plan = make_tile_plan(comm.size, cam, config, k_exch)
    H, W = cam.height, cam.width

    def fn(means, quats, scales, opac, shs, valid, bg):
        out_loc, _, (dropped, _, _) = tile_render_local(
            plan, cam, config, sh_degree, comm, means, quats, scales, opac,
            shs, valid)
        out = all_gather(out_loc, comm, dim=1)[:, :H, :W]
        t_fin = out[blend_ref.N_ACCUM]
        rgb = out[0:3] + t_fin[None] * bg[:, None, None]
        return rgb, out[3:4], 1.0 - t_fin[None], dropped

    return fn
