"""Tile blend forward and backward: CUDA kernels K1 and K2, their plain
PyTorch versions, and the autograd Function around them.

Counterpart of vegs_tpu/ops/blend_pallas.py.

`blend` replaces the Pallas kernel `_fwd_kernel` (blend_pallas.py:201,
launched by `_blend_fwd_impl`:464). On a CUDA tensor it launches the
hand-written kernel in `csrc/blend_fwd.cu` (one block per tile of up to
1024 pixels, one thread per pixel, each warp on an 8x4 rectangle,
256-instance batches staged in shared memory with cp.async, each warp
walking only the instances whose footprint box reaches its pixels, log-T
carry, block-wide early exit -- see the source note there: the kernel is
bound by its per-pixel scalar math, not by memory). On a CPU tensor it runs
`blend_ref_tiles`, the plain version, which walks each tile's padded range
in 256-instance windows as dense [256, P] tensor ops over the spec's
log-space trajectory.

`blend_bwd` replaces `_bwd_kernel` (blend_pallas.py:274, launched by
`_blend_bwd_impl`:502): the per-instance gradients from the forward output
and its cotangent in one forward-walking sweep (`csrc/blend_bwd.cu`, one
block per tile, built for 8, 16 or 32 warps: tiles of up to 256, 512 or
1024 pixels; plain version `blend_bwd_ref_tiles`). `check_tile_shape` is
the tile shapes the kernels take. `BlendFn` is the differentiable blend (the
counterpart of `_blend_cv`:560): K1 forward, K2 backward. Nothing falls back
from a kernel to its plain version.

`footprint_box`, `box_hits`, `thread_pixels` and `warp_rects` are the
plain twins of the kernels' per-warp cull (`csrc/splat.cuh`), for the
tests and `chip_smoke.py`; `blend_check` and `blend_bwd_check` launch K1
and K2 with or without the cull compiled in, with its counts, for
`chip_smoke.py`'s bit-identity check only. Neither is on the main path.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import kernels
from .binning import PAD_ALIGN, TileGrid
from .blend_ref import (ALPHA_CLAMP, ALPHA_MIN, N_ACCUM, OUT_CHANNELS, T_EPS,
                        splat_terms)

F32_ROWS = 8    # payload_f32 rows
AUX_ROWS = 16   # payload_aux rows
NEG_CAP = -80.0
MAX_PIXELS = 1024  # K1, K2 and K4 run one block per tile, a thread a pixel

# The footprint box (csrc/splat.cuh): the conic's diagonal shrunk by
# BOX_REL of (diagonal + |b|), tau = ln(255 op) inflated by BOX_TAU_REL and
# BOX_TAU_ABS, a determinant under BOX_MIN_DET of a'c' taken as unbounded.
BOX_REL, BOX_TAU_REL, BOX_TAU_ABS, BOX_MIN_DET = 1e-5, 1e-4, 1e-4, 1e-12
ALPHA_MIN_F32 = torch.tensor(ALPHA_MIN, dtype=torch.float32)  # 1.0f / 255.0f


def check_tile_shape(tile_h: int, tile_w: int) -> None:
    """Raise ValueError for a tile shape the kernels do not take.

    The JAX package's blend takes tiles whose tile_w is a multiple of 16
    (bench.py:54-60: its Pallas kernels pack 8 tiles into one block whose
    lane dimension must fill 128-lane registers). K1, K2 and K4 take those
    of them with at most MAX_PIXELS pixels, a whole number of warps (an
    even tile_h): 16x16, 16x32, 32x16, 32x32, ... . (The TPU kernels'
    (tile_h, 8 tile_w) output blocks also need tile_h a multiple of 8,
    unless one tile row covers the image.)"""
    p = tile_h * tile_w
    if tile_h <= 0 or tile_w <= 0 or tile_w % 16:
        raise ValueError(f"tile {tile_h}x{tile_w}: tile_h must be positive "
                         "and tile_w a positive multiple of 16")
    if p > MAX_PIXELS or p % 32:
        raise ValueError(f"tile {tile_h}x{tile_w}: the kernels take tiles "
                         f"of a multiple of 32 pixels, at most {MAX_PIXELS}")


def _round_up_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the least float32 >= x (__double2float_ru)."""
    y = x.to(torch.float32)
    up = torch.nextafter(y, torch.full_like(y, math.inf))
    return torch.where(y.to(torch.float64) < x, up, y)


def footprint_box(mx, my, a, b, c, op):
    """Twin of `footprint_box` in csrc/splat.cuh: per instance the
    half-widths (rx, ry), float32, of a box around (mx, my) holding every
    pixel whose float32 differences dx = fl(px - mx), dy = fl(py - my)
    `splat_eval` can accept (alpha > 0): -inf (empty) for op < 1/255, +inf
    (unbounded) for a conic not positive definite after the shrink or any
    non-finite input. Evaluated in float64, rounded up."""
    f32 = [torch.as_tensor(x, dtype=torch.float32) for x in (mx, my, a, b, c, op)]
    finite = torch.stack([torch.isfinite(x) for x in f32]).all(dim=0)
    a, b, c, op = (x.to(torch.float64) for x in f32[2:])
    tau = (torch.log(255.0 * op).clamp(min=0.0) * (1.0 + BOX_TAU_REL)
           + BOX_TAU_ABS)
    ab = b.abs()
    a2 = a - BOX_REL * (a + ab)
    c2 = c - BOX_REL * (c + ab)
    det = a2 * c2 - b * b
    pd = (a2 > 0) & (c2 > 0) & (det > BOX_MIN_DET * a2 * c2)
    inf = torch.tensor(math.inf, dtype=torch.float32)
    empty = ~(f32[5] >= ALPHA_MIN_F32)
    out = []
    for num in (c2, a2):
        r = _round_up_f32(torch.sqrt(2.0 * tau * num / det))
        r = torch.where(pd, r, inf)
        r = torch.where(empty, -inf, r)
        out.append(torch.where(finite, r, inf))
    return out[0], out[1]


def box_hits(x0, x1, y0, y1, mx, my, rx, ry):
    """Twin of `box_hits` in csrc/splat.cuh: whether boxes (rx, ry) around
    (mx, my) can reach a pixel of [x0, x1] x [y0, y1] (pixel coordinates),
    from the float32 differences; a NaN never rejects."""
    f = [torch.as_tensor(v, dtype=torch.float32)
         for v in (x0, x1, y0, y1, mx, my, rx, ry)]
    x0, x1, y0, y1, mx, my, rx, ry = f
    return (~(x0 - mx > rx) & ~(x1 - mx < -rx)
            & ~(y0 - my > ry) & ~(y1 - my < -ry))


def thread_pixels(tile_h: int, tile_w: int):
    """Twin of `thread_pixel` in csrc/splat.cuh: the tile-local pixel
    (lx, ly) of each thread of a block, [tile_h * tile_w] int64 each. Warps
    take 8x4 rectangles when tile_w % 8 == 0 and tile_h % 4 == 0, else the
    map is row-major."""
    t = torch.arange(tile_h * tile_w)
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        w, lane, per_row = t // 32, t % 32, tile_w // 8
        return (w % per_row) * 8 + lane % 8, (w // per_row) * 4 + lane // 8
    return t % tile_w, t // tile_w


def warp_rects(tile_h: int, tile_w: int) -> torch.Tensor:
    """[warps, 4] int64: each warp's tile-local (x0, x1, y0, y1), the
    bounding rectangle of its 32 pixels (the kernels' `warp_rect`)."""
    lx, ly = (v.reshape(-1, 32) for v in thread_pixels(tile_h, tile_w))
    return torch.stack([lx.amin(1), lx.amax(1), ly.amin(1), ly.amax(1)], 1)


def _chan_rows(payload_f32: torch.Tensor, payload_aux: torch.Tensor):
    """[11, K] accumulation channels in blend_ref payload-row order 6..16:
    rgb (aux 0-2), depth (f32 row 6), quat (aux 3-6), scale (aux 7-9), in
    payload_f32's dtype."""
    a = payload_aux.to(payload_f32.dtype)
    return torch.cat([a[0:3], payload_f32[6:7], a[3:10]], dim=0)


class _Window(NamedTuple):
    b0: int
    b1: int
    alpha: torch.Tensor     # [nb, P], 0 where skipped or already crossed
    T: torch.Tensor         # [nb, P] transmittance before each instance
    include: torch.Tensor   # [nb, P] bool: composited
    cpos: torch.Tensor      # [P] first crossing in the window (nb if none)
    crossed: torch.Tensor   # [P] bool: crossed before this window
    expp: torch.Tensor      # [nb, P] exp(min(power, 0))
    alpha_raw: torch.Tensor  # [nb, P] opacity * expp


class _TileWalk:
    """The front-to-back walk of one tile's range in 256-instance windows,
    shared by the plain versions of K1 and K2 so that both include exactly
    the same instances: per window, alpha [256, P], the exclusive prefix of
    log(1 - alpha) from the carried log T, the first crossing per pixel, and
    the inclusion set (alpha > 0 before the crossing). The walk leaves the
    range once every pixel has crossed, as the kernels do. It computes in
    payload_f32's dtype (float32 for the kernels' plain versions)."""

    def __init__(self, payload_f32, grid: TileGrid, t: int, s: int, e: int):
        dev, ft = payload_f32.device, payload_f32.dtype
        p = grid.tile_h * grid.tile_w
        self.pf, self.s, self.e = payload_f32, s, e
        self.oy = (t // grid.ntx) * grid.tile_h
        self.ox = (t % grid.ntx) * grid.tile_w
        ar = torch.arange(p, device=dev)
        self.lx = (ar % grid.tile_w).to(ft)
        self.ly = (ar // grid.tile_w).to(ft)
        self.logT = torch.zeros((p,), dtype=ft, device=dev)
        self.crossed = torch.zeros((p,), dtype=torch.bool, device=dev)
        self.stop = torch.full((p,), e - s, dtype=torch.int32, device=dev)
        self.idx_w = torch.arange(PAD_ALIGN, device=dev)[:, None]
        self.zero = torch.zeros((), dtype=ft, device=dev)

    def windows(self):
        px = (self.lx + self.ox)[None, :]
        py = (self.ly + self.oy)[None, :]
        for b0 in range(self.s, self.e, PAD_ALIGN):
            b1 = min(b0 + PAD_ALIGN, self.e)
            rows = [self.pf[r, b0:b1, None] for r in range(6)]
            alpha, valid, expp, alpha_raw = splat_terms(px, py, *rows)
            alpha = torch.where(valid & ~self.crossed[None, :], alpha, self.zero)
            L = torch.log1p(-alpha)
            S = torch.cumsum(L, dim=0) - L
            T = torch.exp(torch.clamp(self.logT[None, :] + S, min=NEG_CAP))
            crossing = (T * (1.0 - alpha) < T_EPS) & (alpha > 0)
            nb = b1 - b0
            idx = self.idx_w[:nb]
            cpos = torch.where(crossing, idx, nb).amin(dim=0)  # [P]
            include = (alpha > 0) & (idx < cpos[None, :])
            yield _Window(b0, b1, alpha, T, include, cpos, self.crossed,
                          expp, alpha_raw)
            self.logT = torch.clamp(
                self.logT + torch.where(include, L, self.zero).sum(dim=0),
                min=NEG_CAP)
            hit = crossing.any(dim=0)
            self.stop = torch.where(hit & ~self.crossed,
                                    (cpos + (b0 - self.s)).to(torch.int32),
                                    self.stop)
            self.crossed = self.crossed | hit
            if bool(self.crossed.all()):
                break


def blend_ref_tiles(payload_f32, payload_aux, tile_starts, grid: TileGrid,
                    hp: int, wp: int, return_stop: bool = False,
                    pairs: dict | None = None, tiles=None,
                    dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of K1. Returns [12, hp, wp] (and, with
    `return_stop`, the per-pixel stop index [hp, wp] int32: the position in
    the tile's range of the instance before which the pixel stopped, or the
    range length).

    With `pairs`, a dict, it also records the work these inputs need, for a
    kernel's bound: "walked" (pixel, instance) pairs whose alpha the walk
    evaluates (each pixel up to and including its stop instance), "tested"
    (of those, alpha > 0: the stop test runs), "included" (composited) and
    "slots" (instances the tiles must read: up to each tile's farthest
    stop).

    `tiles` (tile indices) restricts the walk to those tiles: the others
    keep out = 0 (T = 1) and stop = 0. `dtype` is the dtype the walk
    computes and returns in; float64 serves as a yardstick for the float32
    walks (tests and chip_smoke.py only).

    Per tile, per 256-instance window (`_TileWalk`): acc += (alpha * T)^T @
    channels over the included instances."""
    dev = payload_f32.device
    payload_f32 = payload_f32.to(dtype)
    p = grid.tile_h * grid.tile_w
    out = torch.zeros((OUT_CHANNELS, hp, wp), dtype=dtype, device=dev)
    out[N_ACCUM] = 1.0
    stop = torch.zeros((hp, wp), dtype=torch.int32, device=dev)
    chan = _chan_rows(payload_f32, payload_aux)  # [11, K]
    starts = tile_starts.tolist()
    zero = torch.zeros((), dtype=dtype, device=dev)
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    for t in range(grid.num_tiles) if tiles is None else tiles:
        walk = _TileWalk(payload_f32, grid, t, starts[t], starts[t + 1])
        walked_px = torch.zeros((p,), dtype=torch.int64, device=dev)
        acc = torch.zeros((p, N_ACCUM), dtype=dtype, device=dev)
        for win in walk.windows():
            if pairs is not None:
                upto = walk.idx_w[:win.b1 - win.b0] <= win.cpos[None, :]
                walked_px += (upto & ~win.crossed[None, :]).sum(dim=0)
                work[1] += ((win.alpha > 0) & upto).sum()
                work[2] += win.include.sum()
            w = torch.where(win.include, win.alpha * win.T, zero)
            acc = acc + w.T @ chan[:, win.b0:win.b1].T
        if pairs is not None:
            work[0] += walked_px.sum()
            work[3] += walked_px.max()
        tile_out = torch.cat([acc, torch.exp(walk.logT)[:, None]], dim=1)
        oy, ox = walk.oy, walk.ox
        out[:, oy:oy + grid.tile_h, ox:ox + grid.tile_w] = (
            tile_out.T.reshape(OUT_CHANNELS, grid.tile_h, grid.tile_w))
        stop[oy:oy + grid.tile_h, ox:ox + grid.tile_w] = walk.stop.reshape(
            grid.tile_h, grid.tile_w)
    if pairs is not None:
        pairs.update(zip(("walked", "tested", "included", "slots"),
                         work.tolist()))
    return (out, stop) if return_stop else out


def blend_bwd_ref_tiles(payload_f32, payload_aux, tile_starts, out, dout,
                        grid: TileGrid, tiles=None,
                        dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of K2: per-instance gradients (dpf [8, K] f32,
    dpa [16, K] in the aux dtype) of the blend, from the forward output `out`
    and its cotangent `dout` ([12, hp, wp] each).

    The same walk as `blend_ref_tiles` (`_TileWalk`), seeded per pixel with
    tail = sum_c dout_c * out_c, and per window the formulas of the Pallas
    backward (blend_pallas.py:363-393): w = alpha T, dw = dout . chan,
    cum_incl = cum + inclusive prefix of w dw, dL = tail - cum_incl,
    dalpha = (T dw - dL / (1 - alpha)) on included pairs, dpower = dalpha
    alpha and dop = dalpha exp(power) where alpha_raw < 0.99; the conic and
    mean gradients from dpower times the tile-local pixel monomials. Slots
    the walk never reaches, and past tile_starts[-1], get zeros.

    `tiles` restricts the walk to those tile indices (the others' slots
    stay 0). `dtype` is the dtype it computes in; with float64 (a yardstick
    for the float32 walks, tests and chip_smoke.py only) dpa is returned in
    float64 too, not in the aux dtype."""
    dev = payload_f32.device
    payload_f32, out, dout = (x.to(dtype) for x in (payload_f32, out, dout))
    k = payload_f32.shape[1]
    th, tw = grid.tile_h, grid.tile_w
    dpf = torch.zeros((F32_ROWS, k), dtype=dtype, device=dev)
    dpa = torch.zeros((AUX_ROWS, k), dtype=dtype, device=dev)
    chan = _chan_rows(payload_f32, payload_aux)  # [11, K]
    tail_map = (dout * out).sum(dim=0)           # [hp, wp]
    starts = tile_starts.tolist()
    zero = torch.zeros((), dtype=dtype, device=dev)
    for t in range(grid.num_tiles) if tiles is None else tiles:
        s, e = starts[t], starts[t + 1]
        if e <= s:
            continue
        walk = _TileWalk(payload_f32, grid, t, s, e)
        oy, ox = walk.oy, walk.ox
        dpix = dout[:N_ACCUM, oy:oy + th, ox:ox + tw].reshape(N_ACCUM, -1).T
        tail = tail_map[oy:oy + th, ox:ox + tw].reshape(-1)   # [P]
        mono = torch.stack([torch.ones_like(walk.lx), walk.lx, walk.ly,
                            walk.lx * walk.lx, walk.ly * walk.ly,
                            walk.lx * walk.ly], dim=1)           # [P, 6]
        cum = torch.zeros_like(tail)
        for win in walk.windows():
            b0, b1 = win.b0, win.b1
            inc = win.include
            w = torch.where(inc, win.alpha * win.T, zero)        # [nb, P]
            dw = chan[:, b0:b1].T @ dpix.T                       # [nb, P]
            wdw = w * dw
            cum_incl = cum[None, :] + torch.cumsum(wdw, dim=0)
            dL = tail[None, :] - cum_incl
            dalpha = torch.where(
                inc, win.T * dw - dL / (1.0 - win.alpha), zero)
            ncl = inc & (win.alpha_raw < ALPHA_CLAMP)
            dpower = torch.where(ncl, dalpha * win.alpha, zero)
            dop = torch.where(ncl, dalpha * win.expp, zero).sum(dim=1)
            dq = dpower @ mono                                   # [nb, 6]
            dchan = w @ dpix                                     # [nb, 11]
            cum = cum_incl[-1]
            mx = payload_f32[0, b0:b1] - ox
            my = payload_f32[1, b0:b1] - oy
            ca, cb, cc = (payload_f32[r, b0:b1] for r in (2, 3, 4))
            q1, qx, qy, qxx, qyy, qxy = dq.unbind(dim=1)
            dpf[0, b0:b1] = q1 * (-ca * mx - cb * my) + qx * ca + qy * cb
            dpf[1, b0:b1] = q1 * (-cc * my - cb * mx) + qx * cb + qy * cc
            dpf[2, b0:b1] = q1 * (-0.5 * mx * mx) + qx * mx - 0.5 * qxx
            dpf[3, b0:b1] = q1 * (-mx * my) + qx * my + qy * mx - qxy
            dpf[4, b0:b1] = q1 * (-0.5 * my * my) + qy * my - 0.5 * qyy
            dpf[5, b0:b1] = dop
            dpf[6, b0:b1] = dchan[:, 3]
            dpa[0:3, b0:b1] = dchan[:, 0:3].T
            dpa[3:10, b0:b1] = dchan[:, 4:11].T
    return dpf, dpa.to(payload_aux.dtype if dtype == torch.float32 else dtype)


def _check_inputs(payload_f32, payload_aux, tile_starts, grid, hp, wp):
    k = payload_f32.shape[1]
    if payload_f32.dtype != torch.float32 or payload_f32.shape[0] != F32_ROWS:
        raise ValueError("payload_f32 must be [8, K] float32")
    if (payload_aux.dtype not in (torch.float32, torch.bfloat16)
            or tuple(payload_aux.shape) != (AUX_ROWS, k)):
        raise ValueError("payload_aux must be [16, K] float32 or bfloat16")
    if tile_starts.dtype != torch.int32 or tile_starts.shape[0] != grid.num_tiles + 1:
        raise ValueError("tile_starts must be [num_tiles + 1] int32")
    if (hp, wp) != (grid.padded_height, grid.padded_width):
        raise ValueError("the output must cover the padded tile grid")
    if k % PAD_ALIGN != 0:
        raise ValueError("K must be a multiple of PAD_ALIGN")
    devs = {payload_f32.device, payload_aux.device, tile_starts.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _contiguous(*ts):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


_FWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _entry(lib: str, symbol: str, argtypes):
    fn = getattr(kernels.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(payload_f32, payload_aux, tile_starts, grid, hp, wp, stop,
            symbol="vegs_blend_fwd", stats=None):
    _contiguous(payload_f32, payload_aux, tile_starts)
    check_tile_shape(grid.tile_h, grid.tile_w)
    fn = _entry("blend_fwd", symbol, _FWD_ARGS)
    dev = payload_f32.device
    out = torch.empty((OUT_CHANNELS, hp, wp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(payload_f32.data_ptr(), payload_aux.data_ptr(),
                 int(payload_aux.dtype == torch.bfloat16),
                 tile_starts.data_ptr(), payload_f32.shape[1], grid.ntx,
                 grid.nty, grid.tile_h, grid.tile_w, out.data_ptr(),
                 _ptr(stop), _ptr(stats), stream)
    kernels.check(err, symbol)
    return out


def blend(payload_f32, payload_aux, tile_starts, grid: TileGrid, hp: int,
          wp: int, return_stop: bool = False):
    """Composite sorted instances into a [12, hp, wp] image (spec:
    blend_ref). payload_f32 [8, K] f32, payload_aux [16, K] bf16 or f32,
    tile_starts [T+1] int32 (multiples of 256). CUDA tensors launch K1;
    CPU tensors run `blend_ref_tiles`."""
    _check_inputs(payload_f32, payload_aux, tile_starts, grid, hp, wp)
    if payload_f32.device.type == "cpu":
        return blend_ref_tiles(payload_f32, payload_aux, tile_starts, grid,
                               hp, wp, return_stop=return_stop)
    if payload_f32.device.type != "cuda":
        raise ValueError(f"no blend kernel for device {payload_f32.device}")
    stop = (torch.empty((hp, wp), dtype=torch.int32, device=payload_f32.device)
            if return_stop else None)
    out = _launch(payload_f32, payload_aux, tile_starts, grid, hp, wp, stop)
    blend.launches += 1
    return (out, stop) if return_stop else out


blend.launches = 0  # K1 launches: incremented where the kernel is launched


def _launch_bwd(payload_f32, payload_aux, tile_starts, out, dout, grid,
                symbol="vegs_blend_bwd", stats=None):
    _contiguous(payload_f32, payload_aux, tile_starts, out, dout)
    check_tile_shape(grid.tile_h, grid.tile_w)
    fn = _entry("blend_bwd", symbol, _BWD_ARGS)
    dev = payload_f32.device
    k = payload_f32.shape[1]
    # zeros: slots the walk never reaches keep a zero gradient
    dpf = torch.zeros((F32_ROWS, k), dtype=torch.float32, device=dev)
    dpa = torch.zeros((AUX_ROWS, k), dtype=payload_aux.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(payload_f32.data_ptr(), payload_aux.data_ptr(),
                 int(payload_aux.dtype == torch.bfloat16),
                 tile_starts.data_ptr(), k, grid.ntx, grid.nty, grid.tile_h,
                 grid.tile_w, out.data_ptr(), dout.data_ptr(), dpf.data_ptr(),
                 dpa.data_ptr(), _ptr(stats), stream)
    kernels.check(err, symbol)
    return dpf, dpa


def _check_bwd_inputs(payload_f32, payload_aux, tile_starts, out, dout, grid):
    hp, wp = grid.padded_height, grid.padded_width
    _check_inputs(payload_f32, payload_aux, tile_starts, grid, hp, wp)
    for name, x in (("out", out), ("dout", dout)):
        if x.dtype != torch.float32 or tuple(x.shape) != (OUT_CHANNELS, hp, wp):
            raise ValueError(f"{name} must be [12, hp, wp] float32")
        if x.device != payload_f32.device:
            raise ValueError(f"{name} is on {x.device}, the payload on "
                             f"{payload_f32.device}")


def blend_bwd(payload_f32, payload_aux, tile_starts, out, dout,
              grid: TileGrid):
    """Per-instance gradients of `blend` (dpf [8, K] f32, dpa [16, K] in
    the aux dtype) from its output `out` and the cotangent `dout`, both
    [12, hp, wp] over the padded grid. CUDA tensors launch K2; CPU tensors
    run `blend_bwd_ref_tiles`."""
    _check_bwd_inputs(payload_f32, payload_aux, tile_starts, out, dout, grid)
    if payload_f32.device.type == "cpu":
        return blend_bwd_ref_tiles(payload_f32, payload_aux, tile_starts,
                                   out, dout, grid)
    if payload_f32.device.type != "cuda":
        raise ValueError(f"no blend kernel for device {payload_f32.device}")
    dpf, dpa = _launch_bwd(payload_f32, payload_aux, tile_starts, out, dout,
                           grid)
    blend_bwd.launches += 1
    return dpf, dpa


blend_bwd.launches = 0  # K2 launches: incremented where the kernel is launched


def cull_variant(symbol: str, payload_f32, cull: bool, counts: bool):
    """The C entry with the cull compiled in or out, and a zeroed [2] int64
    buffer for its counts (or None)."""
    if payload_f32.device.type != "cuda":
        raise ValueError("the kernel variants run on a CUDA device only")
    stats = (torch.zeros(2, dtype=torch.int64, device=payload_f32.device)
             if counts else None)
    return symbol if cull else symbol + "_nocull", stats


def cull_counts(stats):
    if stats is None:
        return None
    considered, walked = (int(x) for x in stats.tolist())
    return {"warp_instances": considered, "walked": walked,
            "skipped_share": 1.0 - walked / considered if considered else 0.0}


def blend_check(payload_f32, payload_aux, tile_starts, grid: TileGrid,
                hp: int, wp: int, cull: bool, counts: bool = True):
    """K1 with the per-warp cull compiled in (`cull`, the main path's
    kernel) or out (`vegs_blend_fwd_nocull`), for the bit-identity check
    and its timing in chip_smoke.py only: (out, stop, counts), where
    counts has the warp-instance pairs the warps considered, those they
    walked and the share the cull skipped (None without `counts`: then
    nothing waits on the card). CUDA tensors only; not counted in
    `blend.launches`."""
    _check_inputs(payload_f32, payload_aux, tile_starts, grid, hp, wp)
    symbol, stats = cull_variant("vegs_blend_fwd", payload_f32, cull, counts)
    stop = torch.empty((hp, wp), dtype=torch.int32, device=payload_f32.device)
    out = _launch(payload_f32, payload_aux, tile_starts, grid, hp, wp, stop,
                  symbol, stats)
    return out, stop, cull_counts(stats)


def blend_bwd_check(payload_f32, payload_aux, tile_starts, out, dout,
                    grid: TileGrid, cull: bool, counts: bool = True):
    """K2 with the per-warp cull compiled in or out, as `blend_check`:
    (dpf, dpa, counts). CUDA tensors only; not counted in
    `blend_bwd.launches`."""
    _check_bwd_inputs(payload_f32, payload_aux, tile_starts, out, dout, grid)
    symbol, stats = cull_variant("vegs_blend_bwd", payload_f32, cull, counts)
    dpf, dpa = _launch_bwd(payload_f32, payload_aux, tile_starts, out, dout,
                           grid, symbol, stats)
    return dpf, dpa, cull_counts(stats)


def kernel_info(lib: str, aux_dtype: torch.dtype, pixels: int) -> dict:
    """The main path's K1 ("blend_fwd") or K2 ("blend_bwd") for tiles of
    `pixels` pixels and this aux dtype, as the CUDA runtime reports it
    (`kernels.kernel_info`). Needs a card."""
    return kernels.kernel_info(lib, int(aux_dtype == torch.bfloat16), pixels)


class BlendFn(torch.autograd.Function):
    """The differentiable blend: K1 forward, K2 backward. The forward saves
    its padded output [12, hp, wp] as the residual (K2 seeds each pixel's
    walk from it); the backward receives the padded cotangent, zero outside
    the image."""

    @staticmethod
    def forward(ctx, payload_f32, payload_aux, tile_starts, grid, hp, wp):
        out = blend(payload_f32, payload_aux, tile_starts, grid, hp, wp)
        ctx.grid = grid
        ctx.save_for_backward(payload_f32, payload_aux, tile_starts, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        payload_f32, payload_aux, tile_starts, out = ctx.saved_tensors
        dpf, dpa = blend_bwd(payload_f32, payload_aux, tile_starts, out,
                             dout.contiguous(), ctx.grid)
        return dpf, dpa, None, None, None, None
