"""Tile binning, forward only (port of vegs_tpu/ops/binning.py).

Expands Gaussians into per-tile instances, sorts them by (tile, depth) and
lays them out in 256-slot-aligned per-tile ranges. Plain PyTorch index math
on int32; `torch.sort(stable=True)` on the same packed key.

Layout contract (consumed by the blend kernels):
  * Each tile's range [tile_starts[t], tile_starts[t+1]) is padded to a
    multiple of PAD_ALIGN (=256) slots.
  * Padding slots carry gidx == n (callers append one zero-opacity payload
    row at index n) and sort_keys == SENTINEL.
  * Instances within a tile are depth-ordered (quantized keys); ties keep
    no defined order (the JAX sort is unstable), so tests compare gidx as a
    multiset within each run of equal keys.
  * k_cap is a multiple of 512; overflow drops instances from the tail and
    `num_dropped` reports how many.

Key packing: key = tile_id << S | (float32_bits(depth) >> (31 - S)) with
S = grid.tile_shift (19 while the grid fits 4094 tiles).

With `want_grad_maps=True`, `bin_gaussians` also returns the raw->padded
slot map `order` and the per-Gaussian exclusive ends `gauss_ends` that the
gather's backward (`rasterize.GatherExpand`) segment-reduces by.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import trace

TILE_SHIFT = 19
MAX_TILES = 4094
MIN_TILE_SHIFT = 10
PAD_ALIGN = 256
SENTINEL = 2**31 - 1

I32 = torch.int32


class TileGrid(NamedTuple):
    tile_h: int
    tile_w: int
    ntx: int  # tiles in x
    nty: int  # tiles in y

    @property
    def num_tiles(self) -> int:
        return self.ntx * self.nty

    @property
    def tile_shift(self) -> int:
        """Depth bits of the packed sort key: 19 while the grid fits
        MAX_TILES, shrinking for larger grids so tile ids always fit."""
        s = TILE_SHIFT
        while s > MIN_TILE_SHIFT and self.num_tiles > (1 << (31 - s)) - 2:
            s -= 1
        if self.num_tiles > (1 << (31 - s)) - 2:
            raise ValueError(
                f"{self.num_tiles} tiles exceeds the packed sort-key "
                f"capacity ({(1 << (31 - MIN_TILE_SHIFT)) - 2} at the "
                f"{MIN_TILE_SHIFT}-bit depth floor); raise "
                "RasterizeConfig.tile_h/tile_w for images this large")
        return s

    @staticmethod
    def for_image(height: int, width: int, tile_h: int = 16, tile_w: int = 16,
                  ntx_align: int = 8) -> "TileGrid":
        """Tile grid covering the image, ntx rounded up to `ntx_align` so
        layouts compare exactly with the JAX package's."""
        ntx = -(-width // tile_w)
        ntx = -(-ntx // ntx_align) * ntx_align
        nty = -(-height // tile_h)
        grid = TileGrid(tile_h, tile_w, ntx, nty)
        grid.tile_shift  # validate the packed-key capacity (raises if over)
        return grid

    @property
    def padded_height(self) -> int:
        return self.nty * self.tile_h

    @property
    def padded_width(self) -> int:
        return self.ntx * self.tile_w


class RawBinned(NamedTuple):
    """The (tile, depth)-sorted instance stream before the padded relayout."""
    key_sorted: torch.Tensor   # [k_cap] packed keys (SENTINEL tail)
    gidx_sorted: torch.Tensor  # [k_cap] Gaussian index per sorted instance
    rawslot_sorted: torch.Tensor  # [k_cap] raw slot of each sorted instance
    gidx_raw: torch.Tensor     # [k_cap] Gaussian index per raw slot
    raw_starts: torch.Tensor   # [num_tiles + 1] unpadded per-tile ranges
    num_real: torch.Tensor     # scalar: sorted entries surviving the cull
    total: torch.Tensor        # scalar: pre-cap instance count
    num_raw: torch.Tensor      # scalar: min(total, k_cap)
    cum: torch.Tensor          # [n] inclusive per-Gaussian count cumsum


class Binned(NamedTuple):
    gidx: torch.Tensor          # [k_pad] int32: slot -> Gaussian (n = dummy)
    tile_starts: torch.Tensor   # [num_tiles + 1] int32, multiples of PAD_ALIGN
    sort_keys: torch.Tensor | None  # [k_pad] int32 keys (SENTINEL = padding)
    num_instances: torch.Tensor  # scalar int32: real instances kept
    num_dropped: torch.Tensor    # scalar int32: instances lost to capacity
    gauss_ends: torch.Tensor     # [n] exclusive end of each Gaussian's rows
    #                              in `order` (min(cum, k_cap) without the
    #                              sat cull)
    order: torch.Tensor | None = None  # [kr] int32: row -> padded slot
    #                              (k_pad = dropped); None without grad maps


def shift_right_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 (torch's >> is arithmetic)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    # torch.cumsum promotes int32 to int64; the JAX version stays int32.
    return torch.cumsum(x, dim=0).to(I32)


def depth_key(depths: torch.Tensor, tile_shift: int = TILE_SHIFT) -> torch.Tensor:
    """Order-preserving `tile_shift`-bit quantization of positive float32
    depths (drops the low 31 - tile_shift mantissa bits)."""
    bits = depths.to(torch.float32).contiguous().view(I32)
    return shift_right_logical(bits, 31 - tile_shift)


def tile_rects(means2d, radii, grid: TileGrid):
    """Inclusive tile-index rectangles covered by each footprint (CUDA
    getRect convention). `radii` is [N] (square) or [N, 2] (per-axis)."""
    mx, my = means2d[:, 0], means2d[:, 1]
    if radii.ndim == 2:
        rx = radii[:, 0].to(means2d.dtype)
        ry = radii[:, 1].to(means2d.dtype)
    else:
        rx = ry = radii.to(means2d.dtype)
    x0 = torch.clamp(torch.floor((mx - rx) / grid.tile_w), 0, grid.ntx - 1).to(I32)
    y0 = torch.clamp(torch.floor((my - ry) / grid.tile_h), 0, grid.nty - 1).to(I32)
    x1 = torch.clamp(
        torch.floor((mx + rx + grid.tile_w - 1) / grid.tile_w) - 1, 0, grid.ntx - 1
    ).to(I32)
    y1 = torch.clamp(
        torch.floor((my + ry + grid.tile_h - 1) / grid.tile_h) - 1, 0, grid.nty - 1
    ).to(I32)
    return x0, y0, x1, y1


DMAX_QUANT = 12.0  # dmax = 2*ln(255*op) <= 2*ln(255) ~ 11.09 for op <= 1

# Cull-compact: Gaussians whose AABB rect has <= J_CAP tile cells get their
# ellipse-tile cull evaluated BEFORE slot assignment, so culled cells never
# take raw-stream slots. The rec's col1 packs (h-1) in 3 bits above a
# _CUM_BITS offset, so the path needs k_cap < 2^23.
J_CAP = 8
_CUM_BITS = 23
_CUM_MASK = (1 << _CUM_BITS) - 1
COMPACT_MAX_N = 1_000_000


def _conic_invs(ca, cc):
    """Reciprocals of the clamped conic diagonal (IEEE division)."""
    return (1.0 / torch.clamp(ca, min=1e-12), 1.0 / torch.clamp(cc, min=1e-12))


def _cell_qmin(ca, cb, cc, lx, hx, ly, hy, inv_a, inv_c):
    """Minimum of q = a dx^2 + 2 b dx dy + c dy^2 over the pixel rect
    [lx, hx] x [ly, hy] (relative to the splat mean): 0 if the mean is
    inside, else the min over the 4 clamped edge parabolas."""
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)

    def q_at(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def edge_x(d):  # dx fixed at d, minimize over dy in [ly, hy]
        dy = torch.minimum(torch.maximum(-cb * d * inv_c, ly), hy)
        return q_at(d, dy)

    def edge_y(e):  # dy fixed at e, minimize over dx in [lx, hx]
        dx = torch.minimum(torch.maximum(-cb * e * inv_a, lx), hx)
        return q_at(dx, e)

    qmin = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)),
        torch.minimum(edge_y(ly), edge_y(hy)))
    return torch.where(inside, torch.zeros_like(qmin), qmin)


def bin_raw(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    grid: TileGrid,
    k_cap: int,
    conics: torch.Tensor | None = None,
    opacities: torch.Tensor | None = None,
    compact: bool | None = None,
) -> RawBinned:
    """Expand each active Gaussian (radii > 0) into one instance per covered
    tile, sorted by (tile, quantized depth): the raw stream, no relayout.

    With `conics`/`opacities`, each AABB tile cell also passes the exact
    ellipse-tile cull (dropped when the minimum Mahalanobis form over the
    tile exceeds 2 ln(255 op), i.e. alpha < 1/255 at every pixel: lossless).
    `compact` selects the pre-assignment cull for small rects (None = on up
    to COMPACT_MAX_N Gaussians, as in the JAX package)."""
    n = means2d.shape[0]
    dev = means2d.device
    if k_cap % 512 != 0:
        raise ValueError("k_cap must be a multiple of 512")
    num_tiles = grid.num_tiles
    tile_shift = grid.tile_shift
    if grid.ntx > 2048 or grid.nty > 2048:
        raise ValueError(
            f"{grid.ntx}x{grid.nty} tile grid exceeds the 2048 per-axis "
            "packing bound; raise tile_h/tile_w")
    do_cull = conics is not None and opacities is not None
    if compact is None:
        compact = n <= COMPACT_MAX_N
    compact = do_cull and compact and k_cap < (1 << _CUM_BITS)

    active = (radii.min(dim=1).values if radii.ndim == 2 else radii) > 0
    x0, y0, x1, y1 = tile_rects(means2d, radii, grid)
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    wh = w * h

    if do_cull:
        op_ = opacities.reshape(n)
        dmax = 2.0 * torch.log(torch.clamp(255.0 * op_, min=1.0 + 1e-6))
        dmax_q = torch.clamp(
            torch.ceil(dmax * (255.0 / DMAX_QUANT)), max=255.0).to(I32)
        ca, cb, cc = conics[:, 0], conics[:, 1], conics[:, 2]
    else:
        dmax_q = torch.zeros_like(x0)
        ca = cb = cc = torch.zeros((n,), dtype=torch.float32, device=dev)

    zero_i = torch.zeros((), dtype=I32, device=dev)
    if compact:
        small = active & (wh <= J_CAP)
        gdmax_n = dmax_q.to(torch.float32) * (DMAX_QUANT / 255.0)
        mx_, my_ = means2d[:, 0], means2d[:, 1]
        recip_w = 1.0 / w.to(torch.float32)
        inv_a_n, inv_c_n = _conic_invs(ca, cc)
        cnt = torch.zeros((n,), dtype=I32, device=dev)
        for j in range(J_CAP):
            # variable-divisor div via the exact biased float reciprocal
            qj = torch.floor((j + 0.5) * recip_w).to(I32)
            rj = j - qj * w
            lx = (x0 + rj).to(torch.float32) * grid.tile_w - mx_
            ly = (y0 + qj).to(torch.float32) * grid.tile_h - my_
            qmin_j = _cell_qmin(ca, cb, cc, lx, lx + (grid.tile_w - 1),
                                ly, ly + (grid.tile_h - 1), inv_a_n, inv_c_n)
            cnt += ((j < wh) & (qmin_j <= gdmax_n)).to(I32)
        counts = torch.where(active, torch.where(small, cnt, wh), zero_i)
    else:
        small = torch.zeros((n,), dtype=torch.bool, device=dev)
        counts = torch.where(active, wh, zero_i)

    cum = _cumsum_i32(counts)             # inclusive, [n]
    total = cum[-1] if n > 0 else zero_i
    num_raw = torch.clamp(total, max=k_cap)
    cum_excl = cum - counts

    # Slot -> Gaussian index: add each nonempty Gaussian's index delta (to
    # the previous nonempty one) at its run start, then integrate with one
    # cumsum.
    with trace.span("bin.nonzero", sync=True):
        nonempty = torch.nonzero(counts > 0).squeeze(1)  # ascending
    start_val = torch.diff(nonempty, prepend=nonempty.new_zeros(1)).to(I32)
    start_idx = cum_excl[nonempty].long()
    inb = start_idx < k_cap
    z = torch.zeros((k_cap,), dtype=I32, device=dev)
    with trace.span("bin.mask", sync=True):  # a boolean mask's index syncs
        z.index_add_(0, start_idx[inb], start_val[inb])
    gidx_raw = _cumsum_i32(z)
    slot = torch.arange(k_cap, dtype=I32, device=dev)

    # One packed [n, 8] int32 record per Gaussian, gathered once per slot:
    # col0 = x0 | y0<<12 | dmax_q<<24; col1 = cum_excl (23 bits under
    # `compact`) | (h-1)<<23 | small<<26; col2 = dkey | w<<S; cols 3..7 =
    # conic a/b/c, mx, my as f32 bits.
    def bc(v):
        return v.to(torch.float32).contiguous().view(I32)

    if compact:
        col1 = ((cum_excl & _CUM_MASK)
                | (((h - 1) & 7) << _CUM_BITS)
                | (small.to(I32) << (_CUM_BITS + 3)))
    else:
        col1 = cum_excl
    rec = torch.stack(
        [x0 | (y0 << 12) | (dmax_q << 24),
         col1,
         depth_key(depths, tile_shift) | (w << tile_shift),
         bc(ca), bc(cb), bc(cc),
         bc(means2d[:, 0]), bc(means2d[:, 1])],
        dim=1,
    )  # [n, 8] int32
    rec_g = rec[gidx_raw.long()]  # [k_cap, 8]
    mask12 = (1 << 12) - 1
    gx0 = rec_g[:, 0] & mask12
    gy0 = shift_right_logical(rec_g[:, 0], 12) & mask12
    if compact:
        goff = rec_g[:, 1] & _CUM_MASK
        gh = (shift_right_logical(rec_g[:, 1], _CUM_BITS) & 7) + 1
        gsmall = shift_right_logical(rec_g[:, 1], _CUM_BITS + 3) > 0
    else:
        goff = rec_g[:, 1]
    gdkey = rec_g[:, 2] & ((1 << tile_shift) - 1)
    gw_ = shift_right_logical(rec_g[:, 2], tile_shift)

    in_range = slot < num_raw
    li = slot - goff
    gw = torch.clamp(gw_, min=1)
    # li < w*h is exact in f32 and (li + 0.5)/gw never sits on an integer
    # for gw < 2^11, so the biased float reciprocal gives the exact quotient.
    recip_gw = 1.0 / gw.to(torch.float32)
    q = torch.floor((li.to(torch.float32) + 0.5) * recip_gw).to(I32)
    r_big = li - q * gw
    q_big = q

    keep = in_range
    if do_cull:
        def fbc(v):
            return v.contiguous().view(torch.float32)

        ga, gb, gc = fbc(rec_g[:, 3]), fbc(rec_g[:, 4]), fbc(rec_g[:, 5])
        gmx, gmy = fbc(rec_g[:, 6]), fbc(rec_g[:, 7])
        gdmax = (shift_right_logical(rec_g[:, 0], 24) & 255
                 ).to(torch.float32) * (DMAX_QUANT / 255.0)
        inv_ga, inv_gc = _conic_invs(ga, gc)
    # the records are read: free them before the sort, where a training
    # step's device memory peaks
    del rec, rec_g, goff

    if compact:
        # Small rects: slot li holds the li-th SURVIVING cell.
        gwh = gw * gh
        c = torch.zeros_like(li)
        sel_r = torch.zeros_like(li)
        sel_q = torch.zeros_like(li)
        for j in range(J_CAP):
            qj = torch.floor((j + 0.5) * recip_gw).to(I32)
            rj = j - qj * gw
            lx_j = (gx0 + rj).to(torch.float32) * grid.tile_w - gmx
            ly_j = (gy0 + qj).to(torch.float32) * grid.tile_h - gmy
            qmin_j = _cell_qmin(ga, gb, gc, lx_j, lx_j + (grid.tile_w - 1),
                                ly_j, ly_j + (grid.tile_h - 1),
                                inv_ga, inv_gc)
            keep_j = (j < gwh) & (qmin_j <= gdmax)
            hit = keep_j & (c == li)
            sel_r = torch.where(hit, rj, sel_r)
            sel_q = torch.where(hit, qj, sel_q)
            c += (gsmall & keep_j).to(I32)
        tx = gx0 + torch.where(gsmall, sel_r, r_big)
        ty = gy0 + torch.where(gsmall, sel_q, q_big)
        keep = keep & (~gsmall | (li < c))
    else:
        tx = gx0 + r_big
        ty = gy0 + q_big
    tile_id = ty * grid.ntx + tx

    if do_cull:
        lx = tx.to(torch.float32) * grid.tile_w - gmx
        ly = ty.to(torch.float32) * grid.tile_h - gmy
        qmin = _cell_qmin(ga, gb, gc, lx, lx + (grid.tile_w - 1),
                          ly, ly + (grid.tile_h - 1), inv_ga, inv_gc)
        keep = keep & (qmin <= gdmax)

    key = torch.where(keep, (tile_id << tile_shift) | gdkey,
                      torch.full_like(tile_id, SENTINEL))
    # The sort's permutation is the raw slot of each sorted instance (the
    # JAX package carries the slot through its sort as an extra operand).
    key_sorted, perm = torch.sort(key, stable=True)
    gidx_sorted = gidx_raw[perm]

    queries = torch.arange(num_tiles + 1, dtype=I32, device=dev) << tile_shift
    raw_starts = torch.searchsorted(key_sorted, queries, side="left").to(I32)
    return RawBinned(
        key_sorted=key_sorted,
        gidx_sorted=gidx_sorted,
        rawslot_sorted=perm.to(I32),
        gidx_raw=gidx_raw,
        raw_starts=raw_starts,
        num_real=raw_starts[num_tiles],
        total=total,
        num_raw=num_raw,
        cum=cum,
    )


def pad_relayout(
    key_sorted: torch.Tensor,    # [k_src] sorted packed keys (SENTINEL tail)
    carry_sorted: torch.Tensor,  # [k_src] int32 value carried per instance
    raw_starts: torch.Tensor,    # [num_tiles + 1]
    num_tiles: int,
    k_cap: int,
    dummy: int,
    want_keys: bool = True,
    counts_override: torch.Tensor | None = None,  # [num_tiles] per-tile clip
):
    """Re-lay a (tile, depth)-sorted stream into the padded per-tile layout:
    each tile's range is padded to a PAD_ALIGN multiple; padding slots carry
    `dummy` / SENTINEL. `counts_override` (e.g. satcull counts) keeps only
    the leading counts_override[t] instances of tile t.

    Returns (carry_padded [k_cap], keys_padded [k_cap] or None,
             padded_starts [num_tiles + 1], num_kept scalar)."""
    if k_cap % PAD_ALIGN != 0:
        raise ValueError("k_pad must be a multiple of PAD_ALIGN")
    dev = key_sorted.device
    k_src = key_sorted.shape[0]
    num_real = raw_starts[num_tiles]
    tile_counts = raw_starts[1:] - raw_starts[:-1]  # [T]
    if counts_override is not None:
        tile_counts = torch.minimum(tile_counts, counts_override.to(I32))

    padded_counts = (tile_counts + (PAD_ALIGN - 1)) // PAD_ALIGN * PAD_ALIGN
    padded_starts = torch.cat(
        [torch.zeros((1,), dtype=I32, device=dev), _cumsum_i32(padded_counts)])
    padded_starts = torch.clamp(padded_starts, max=k_cap)

    # Per-slot tile lookups: add per-tile value deltas at the padded range
    # boundaries (boundaries clamped to k_cap fall off the end), cumsum.
    bounds = padded_starts[:-1].long()
    inb = bounds < k_cap

    def tile_broadcast(values):  # [T] -> [k_cap] piecewise-constant
        deltas = torch.cat([values[:1], values[1:] - values[:-1]])
        z = torch.zeros((k_cap,), dtype=values.dtype, device=dev)
        with trace.span("bin.mask", sync=True):
            z.index_add_(0, bounds[inb], deltas[inb])
        return _cumsum_i32(z)

    base_map = tile_broadcast(padded_starts[:-1])
    rawstart_map = tile_broadcast(raw_starts[:-1])
    count_map = tile_broadcast(tile_counts)

    slot = torch.arange(k_cap, dtype=I32, device=dev)
    r_of = slot - base_map
    src = rawstart_map + r_of
    valid = (
        (slot < padded_starts[num_tiles])
        & (r_of < count_map)
        & (src < num_real)
    )
    src_c = torch.clamp(src, 0, k_src - 1).long()
    carry_padded = torch.where(valid, carry_sorted[src_c],
                               torch.full_like(slot, dummy))
    keys_padded = (torch.where(valid, key_sorted[src_c],
                               torch.full_like(slot, SENTINEL))
                   if want_keys else None)
    num_kept = valid.to(I32).sum().to(I32)
    return carry_padded, keys_padded, padded_starts, num_kept


def bin_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    grid: TileGrid,
    k_cap: int,
    conics: torch.Tensor | None = None,
    opacities: torch.Tensor | None = None,
    want_keys: bool = True,
    want_grad_maps: bool = False,
    k_pad: int = 0,
    compact: bool | None = None,
    rb: RawBinned | None = None,
    sat_counts: torch.Tensor | None = None,
) -> Binned:
    """Expand, cull, sort (`bin_raw`) and lay out (`pad_relayout`).

    `k_pad` (0 = k_cap) sizes the padded layout independently of the raw
    capacity; `rb` reuses a precomputed bin_raw result; `sat_counts`
    ([num_tiles], satcull.satcount) clips each tile to its saturation
    prefix, and clipped instances are not counted as dropped.

    `want_grad_maps` adds `order` and per-Gaussian `gauss_ends` for the
    gather's backward. Without `sat_counts`, `order` has one row per raw slot
    (Gaussian-grouped: Gaussian g owns rows [gauss_ends[g-1], gauss_ends[g]))
    holding the padded slot it landed in, k_pad when it did not. With
    `sat_counts` the rows are compacted to the landed instances, still in
    raw order, over min(k_pad, k_cap) rows (the compact backward)."""
    n = means2d.shape[0]
    num_tiles = grid.num_tiles
    if k_pad <= 0:
        k_pad = k_cap
    if rb is None:
        rb = bin_raw(means2d, depths, radii, grid, k_cap,
                     conics=conics, opacities=opacities, compact=compact)
    gidx_padded, keys_padded, padded_starts, num_kept = pad_relayout(
        rb.key_sorted, rb.gidx_sorted, rb.raw_starts, num_tiles, k_pad,
        dummy=n, want_keys=want_keys, counts_override=sat_counts)
    # Capacity losses only: ellipse-culled cells and saturated suffixes are
    # not "dropped".
    raw_counts = rb.raw_starts[1:] - rb.raw_starts[:-1]
    if sat_counts is not None:
        kept_target = torch.minimum(raw_counts, sat_counts.to(I32)).sum().to(I32)
    else:
        kept_target = rb.num_real
    num_dropped = rb.total - (rb.num_raw - rb.num_real) - (
        rb.num_real - kept_target) - num_kept
    order = None
    gauss_ends = torch.clamp(rb.cum, max=k_cap)
    if want_grad_maps:
        order, ends_c = _grad_maps(rb, padded_starts, grid, k_cap, k_pad,
                                   n, sat_counts)
        if ends_c is not None:
            gauss_ends = ends_c
    return Binned(
        gidx=gidx_padded,
        tile_starts=padded_starts,
        sort_keys=keys_padded,
        num_instances=num_kept,
        num_dropped=num_dropped,
        gauss_ends=gauss_ends,
        order=order,
    )


def _grad_maps(rb: RawBinned, padded_starts, grid: TileGrid, k_cap: int,
               k_pad: int, n: int, sat_counts):
    """The raw->padded slot map (`order`) and, under the sat cull, the
    compact per-Gaussian ends (JAX binning.py:686-750).

    Sorted position p of tile t lands at p + padded_starts[t] -
    raw_starts[t] when it is a real instance inside the padded capacity and,
    with `sat_counts`, inside its tile's kept prefix; else it is dropped
    (k_pad). `rawslot_sorted` is a permutation, so `order` in raw order is
    the scatter order[rawslot_sorted] = dest."""
    dev = rb.key_sorted.device
    num_tiles = grid.num_tiles
    slot = torch.arange(k_cap, dtype=I32, device=dev)
    bounds = rb.raw_starts[:-1].long()
    inb = bounds < k_cap

    def bcast(values):  # [T] per tile -> [k_cap] per sorted position
        deltas = torch.cat([values[:1], values[1:] - values[:-1]])
        z = torch.zeros((k_cap,), dtype=I32, device=dev)
        with trace.span("bin.mask", sync=True):
            z.index_add_(0, bounds[inb], deltas[inb])
        return _cumsum_i32(z)

    dest = slot + bcast(padded_starts[:-1] - rb.raw_starts[:-1])
    landed = (slot < rb.num_real) & (dest < padded_starts[num_tiles])
    if sat_counts is not None:
        raw_counts = rb.raw_starts[1:] - rb.raw_starts[:-1]
        kept = torch.minimum(raw_counts, sat_counts.to(I32))
        # clipped tails would alias the next tile's padded range
        landed = landed & (slot - bcast(rb.raw_starts[:-1]) < bcast(kept))
    dest = torch.where(landed, dest, torch.full_like(dest, k_pad))
    raw = rb.rawslot_sorted.long()
    if sat_counts is None:
        order = torch.empty_like(dest)
        order[raw] = dest
        return order, None
    # Compact backward: the landed instances in raw order, over
    # min(k_pad, k_cap) rows; Gaussian g's rows end at the number of landed
    # instances of Gaussians <= g.
    landed_raw = torch.zeros_like(landed)
    landed_raw[raw] = landed
    dest_raw = torch.empty_like(dest)
    dest_raw[raw] = dest
    kr = min(k_pad, k_cap)
    row = _cumsum_i32(landed_raw.to(I32)) - 1
    order = torch.full((kr,), k_pad, dtype=I32, device=dev)
    with trace.span("bin.mask", sync=True):
        order[row[landed_raw].long()] = dest_raw[landed_raw]
    per_g = torch.zeros((n,), dtype=I32, device=dev)
    with trace.span("bin.mask", sync=True):
        per_g.index_add_(0, rb.gidx_raw[landed_raw].long(),
                         torch.ones_like(row[landed_raw]))
    return order, _cumsum_i32(per_g)
