"""Saturation prepass: per-tile kept-instance counts for the sorted raw
stream (port of vegs_tpu/ops/satcull.py).

For each tile, how many leading instances of the raw (tile, depth)-sorted
stream can still contribute to some pixel, at 256-slot window granularity:
the walk replays the blend spec's per-pixel crossing rule with the
threshold tightened to T_EPS * SAFETY (0.5), and the count rounds up to the
window in which the tile's last pixel crosses. `bin_gaussians` clips each
tile's range with these counts before the padded relayout, so everything
downstream runs at the compacted size. Clipped instances sit behind every
pixel's stop, so the cull is lossless.

`satcount` (the JAX package's layout: channel-major rows in sorted order)
and `satcount_gathered` (the main path: the padded [n+1, 8] payload rows
read through the sorted Gaussian index, where they lie) replace the Pallas
kernel `_satcount_kernel` (vegs_tpu/ops/satcull.py:65, launched by
`satcount`:171). On CUDA tensors both launch the hand-written kernel in
`csrc/satcount.cu` (one block per tile, one thread per pixel, 256-slot
windows double-buffered in shared memory with cp.async, K1's per-warp
footprint cull, block-wide exit once every pixel crossed; bound by its
per-pixel scalar math -- see the source note there), each with its own
launch count. On CPU tensors they run `satcount_ref` and
`satcount_gathered_ref`, the plain versions. `satcount_check` launches
the main path's kernel with the cull compiled in or out, for chip_smoke.py
only. `satcount_np` is a numpy copy of the JAX package's loop oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .binning import PAD_ALIGN, TileGrid
from .blend_cuda import check_tile_shape, cull_counts, cull_variant
from .blend_ref import ALPHA_CLAMP, ALPHA_MIN, T_EPS, splat_alpha

NEG_CAP = -80.0
SAFETY = 0.5          # cull threshold = T_EPS * SAFETY


def satcount_ref(pf_cm: torch.Tensor, raw_starts: torch.Tensor,
                 grid: TileGrid, pairs: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4, with the window-vector semantics of
    `satcount_np`: per 256-slot window, alpha [256, P] of the in-range slots
    for the not-yet-crossed pixels, the exclusive log(1 - alpha) prefix from
    the carried log T, the first crossing per pixel and the included sum.

    With `pairs`, a dict, it also records the work these inputs need, as
    `blend_cuda.blend_ref_tiles` does: "walked" (pixel, in-range instance)
    pairs up to and including each pixel's crossing, "tested" (alpha > 0),
    "included" (carried into log T) and "slots" (in-range instances each
    tile must read: up to its farthest crossing)."""
    dev = pf_cm.device
    f32 = torch.float32
    p = grid.tile_h * grid.tile_w
    starts = raw_starts.tolist()
    counts = [0] * grid.num_tiles
    ly = (torch.arange(p, device=dev) // grid.tile_w).to(f32)
    lx = (torch.arange(p, device=dev) % grid.tile_w).to(f32)
    idx_w = torch.arange(PAD_ALIGN, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    k = pf_cm.shape[1]
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    for t in range(grid.num_tiles):
        s, e = starts[t], starts[t + 1]
        counts[t] = e - s
        if e <= s:
            continue
        px = lx + (t % grid.ntx) * grid.tile_w
        py = ly + (t // grid.ntx) * grid.tile_h
        carry = torch.zeros((p,), dtype=f32, device=dev)
        crossed = torch.zeros((p,), dtype=torch.bool, device=dev)
        walked_px = torch.zeros((p,), dtype=torch.int64, device=dev)
        w0 = (s // PAD_ALIGN) * PAD_ALIGN
        nsc = -(-(e - w0) // PAD_ALIGN)
        done_sc = nsc
        for sc in range(nsc):
            g0 = w0 + sc * PAD_ALIGN
            g1 = min(g0 + PAD_ALIGN, k)
            gi = g0 + idx_w[:g1 - g0]
            in_range = ((gi >= s) & (gi < e))[:, None]
            rows = [pf_cm[r, g0:g1, None] for r in range(6)]
            alphas, valid = splat_alpha(px[None, :], py[None, :], *rows)
            alphas = torch.where(valid & in_range & ~crossed[None, :], alphas,
                                 zero)
            L = torch.log1p(-alphas)
            S = torch.cumsum(L, dim=0) - L
            T1 = torch.exp(torch.clamp(carry[None, :] + S, min=NEG_CAP))
            crossing = (T1 * (1 - alphas) < T_EPS * SAFETY) & (alphas > 0)
            nw = g1 - g0
            cpos = torch.where(crossing, idx_w[:nw, None], PAD_ALIGN).amin(dim=0)
            include = (alphas > 0) & (idx_w[:nw, None] < cpos[None, :])
            if pairs is not None:
                upto = idx_w[:nw, None] <= cpos[None, :]
                walked_px += (upto & in_range & ~crossed[None, :]).sum(dim=0)
                work[1] += ((alphas > 0) & upto).sum()
                work[2] += include.sum()
            carry = torch.clamp(
                carry + torch.where(include, L, zero).sum(dim=0), min=NEG_CAP)
            crossed = crossed | crossing.any(dim=0)
            if bool(crossed.all()):
                done_sc = sc + 1
                break
        counts[t] = min(max(w0 + done_sc * PAD_ALIGN - s, 0), e - s)
        if pairs is not None:
            work[0] += walked_px.sum()
            work[3] += walked_px.max()
    if pairs is not None:
        pairs.update(zip(("walked", "tested", "included", "slots"),
                         work.tolist()))
    return torch.tensor(counts, dtype=torch.int32, device=dev)


def satcount_np(pf_cm, raw_starts, grid: TileGrid) -> np.ndarray:
    """Python-loop oracle of the kernel semantics (copy of the JAX
    package's; tests only)."""
    pf = np.asarray(pf_cm, np.float32)
    starts = np.asarray(raw_starts)
    counts = np.zeros(grid.num_tiles, np.int32)
    for t in range(grid.num_tiles):
        s, e = int(starts[t]), int(starts[t + 1])
        counts[t] = e - s
        if e <= s:
            continue
        tx = (t % grid.ntx) * grid.tile_w
        ty = (t // grid.ntx) * grid.tile_h
        pxs, pys = np.meshgrid(np.arange(grid.tile_w), np.arange(grid.tile_h))
        px = (pxs.reshape(-1) + tx).astype(np.float32)
        py = (pys.reshape(-1) + ty).astype(np.float32)
        carry = np.zeros(px.shape[0], np.float32)
        crossed = np.zeros(px.shape[0], bool)
        w0 = (s // PAD_ALIGN) * PAD_ALIGN
        nsc = -(-(e - w0) // PAD_ALIGN)
        done_sc = nsc
        for sc in range(nsc):
            g0 = w0 + sc * PAD_ALIGN
            alphas = np.zeros((PAD_ALIGN, px.shape[0]), np.float32)
            for c in range(PAD_ALIGN):
                gi = g0 + c
                if gi < s or gi >= e:
                    continue
                mx, my, ca, cb, cc, op = pf[:6, gi]
                dx, dy = px - mx, py - my
                power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                araw = op * np.exp(np.minimum(power, 0.0))
                valid = (power <= 0) & (araw >= ALPHA_MIN) & ~crossed
                alphas[c] = np.where(valid, np.minimum(araw, ALPHA_CLAMP), 0.0)
            L = np.log1p(-alphas)
            S = np.cumsum(L, axis=0) - L
            logT_m = np.maximum(carry[None, :] + S, NEG_CAP)
            T1 = np.exp(logT_m)
            crossing = (T1 * (1 - alphas) < T_EPS * SAFETY) & (alphas > 0)
            cpos = np.where(crossing.any(axis=0),
                            crossing.argmax(axis=0), PAD_ALIGN)
            include = (alphas > 0) & (np.arange(PAD_ALIGN)[:, None] < cpos)
            carry = np.maximum(
                carry + np.sum(np.where(include, L, 0.0), axis=0), NEG_CAP)
            crossed |= crossing.any(axis=0)
            if crossed.all():
                done_sc = sc + 1
                break
        kept = min(max(w0 + done_sc * PAD_ALIGN - s, 0), e - s)
        counts[t] = kept
    return counts




def satcount_gathered_ref(pay_f32: torch.Tensor, gidx_sorted: torch.Tensor,
                          raw_starts: torch.Tensor, grid: TileGrid,
                          pairs: dict | None = None) -> torch.Tensor:
    """Plain version of the main path's K4 entry: `satcount_ref` on the
    channel-major rows pay_f32[gidx_sorted].T."""
    return satcount_ref(pay_f32[gidx_sorted.long()].T, raw_starts, grid,
                        pairs)


def _check_grid(raw_starts: torch.Tensor, grid: TileGrid, k: int):
    if k % PAD_ALIGN != 0:
        raise ValueError("k must be a multiple of PAD_ALIGN")
    if raw_starts.dtype != torch.int32 or raw_starts.shape[0] != grid.num_tiles + 1:
        raise ValueError("raw_starts must be [num_tiles + 1] int32")
    # The JAX wrapper walks 8 tiles per program and silently assumes this.
    if grid.ntx % 8 != 0:
        raise ValueError(f"ntx={grid.ntx} must be a multiple of 8 "
                         "(TileGrid.for_image rounds it up)")


def _check_launch(grid: TileGrid, *ts):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    check_tile_shape(grid.tile_h, grid.tile_w)


_ROW_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_CM_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]


def _run(symbol: str, argtypes, lead: tuple, raw_starts, grid: TileGrid,
         stats=None) -> torch.Tensor:
    """Launch `symbol` with its leading arguments `lead`, then the grid, the
    output and `stats` (or null) on the current stream."""
    fn = getattr(kernels.load("satcount"), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    dev = raw_starts.device
    out = torch.empty((grid.num_tiles,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*lead, raw_starts.data_ptr(), grid.ntx, grid.nty,
                 grid.tile_h, grid.tile_w, out.data_ptr(),
                 stats.data_ptr() if stats is not None else None, stream)
    kernels.check(err, symbol)
    return out


def satcount(pf_cm: torch.Tensor, raw_starts: torch.Tensor,
             grid: TileGrid) -> torch.Tensor:
    """Per-tile kept counts for a (tile, depth)-sorted raw stream, in the
    JAX package's layout (the main path reads the rows where they lie:
    `satcount_gathered`).

    pf_cm: [8, k] channel-major f32, rows 0..5 = (mx, my, conic a, b, c,
    opacity) in SORTED order (rows 6..7 ignored); raw_starts [T+1] int32.
    Returns [T] int32. CUDA tensors launch K4 (`vegs_satcount_cm`); CPU
    tensors run `satcount_ref`."""
    if pf_cm.dtype != torch.float32 or pf_cm.ndim != 2 or pf_cm.shape[0] < 6:
        raise ValueError("pf_cm must be [8, k] float32")
    _check_grid(raw_starts, grid, pf_cm.shape[1])
    if pf_cm.device != raw_starts.device:
        raise ValueError("pf_cm and raw_starts on different devices")
    if pf_cm.device.type == "cpu":
        return satcount_ref(pf_cm, raw_starts, grid)
    if pf_cm.device.type != "cuda":
        raise ValueError(f"no satcount kernel for device {pf_cm.device}")
    _check_launch(grid, pf_cm, raw_starts)
    out = _run("vegs_satcount_cm", _CM_ARGS,
               (pf_cm.data_ptr(), pf_cm.shape[1]), raw_starts, grid)
    satcount.launches += 1
    return out


satcount.launches = 0  # K4 launches in the JAX layout


def _check_gathered(pay_f32, gidx_sorted, raw_starts, grid):
    if pay_f32.dtype != torch.float32 or pay_f32.ndim != 2 or pay_f32.shape[1] != 8:
        raise ValueError("pay_f32 must be [n + 1, 8] float32")
    if gidx_sorted.dtype != torch.int32 or gidx_sorted.ndim != 1:
        raise ValueError("gidx_sorted must be [k] int32")
    _check_grid(raw_starts, grid, gidx_sorted.shape[0])
    devs = {pay_f32.device, gidx_sorted.device, raw_starts.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _launch_gathered(pay_f32, gidx_sorted, raw_starts, grid,
                     symbol="vegs_satcount", stats=None):
    _check_launch(grid, pay_f32, gidx_sorted, raw_starts)
    if pay_f32.data_ptr() % 16:
        raise ValueError("pay_f32 must be 16-byte aligned (K4 copies its "
                         "rows with 16-byte cp.async)")
    return _run(symbol, _ROW_ARGS,
                (pay_f32.data_ptr(), pay_f32.shape[0], gidx_sorted.data_ptr()),
                raw_starts, grid, stats)


def satcount_gathered(pay_f32: torch.Tensor, gidx_sorted: torch.Tensor,
                      raw_starts: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """The main path's K4: the counts of `satcount` on
    pay_f32[gidx_sorted].T, reading each walked slot's payload row where it
    lies.

    pay_f32 [n + 1, 8] f32 row-major (the padded payload: row n is the
    zero-opacity dummy), gidx_sorted [k] int32 (each sorted slot's
    Gaussian, any value in [0, n] outside the tiles' ranges), raw_starts
    [T+1] int32. CUDA tensors launch K4 (`vegs_satcount`, with its per-warp
    cull); CPU tensors run `satcount_gathered_ref`."""
    _check_gathered(pay_f32, gidx_sorted, raw_starts, grid)
    if pay_f32.device.type == "cpu":
        return satcount_gathered_ref(pay_f32, gidx_sorted, raw_starts, grid)
    if pay_f32.device.type != "cuda":
        raise ValueError(f"no satcount kernel for device {pay_f32.device}")
    out = _launch_gathered(pay_f32, gidx_sorted, raw_starts, grid)
    satcount_gathered.launches += 1
    return out


satcount_gathered.launches = 0  # K4 launches on the main path


def satcount_check(pay_f32, gidx_sorted, raw_starts, grid: TileGrid,
                   cull: bool, counts: bool = True):
    """The main path's K4 with its per-warp cull compiled in (`cull`) or
    out (`vegs_satcount_nocull`), for chip_smoke.py's bit-identity check and
    timing only: (kept counts, cull counts as `blend_cuda.blend_check`
    gives them, or None without `counts`). CUDA tensors only; not counted
    in `satcount_gathered.launches`."""
    _check_gathered(pay_f32, gidx_sorted, raw_starts, grid)
    symbol, stats = cull_variant("vegs_satcount", pay_f32, cull, counts)
    out = _launch_gathered(pay_f32, gidx_sorted, raw_starts, grid, symbol,
                           stats)
    return out, cull_counts(stats)


def kernel_info(pixels: int) -> dict:
    """The main path's K4 for tiles of `pixels` pixels, as the CUDA runtime
    reports it (`kernels.kernel_info`). Needs a card."""
    return kernels.kernel_info("satcount", pixels)
