"""Gaussian rasterization (port of vegs_tpu/ops/rasterize.py).

Pipeline: project (PyTorch) -> bin + sort (PyTorch index math) -> optional
saturation prepass (kernel K4) -> padded relayout -> payload gather ->
blend (kernel K1, or the dense spec for tests).

Mixed-precision payload, as in the JAX package: an 8-column f32 table
(pixel means, conic, opacity, depth) and a 16-column aux table (rgb, quat,
scale) in bf16 (the default) or f32.

The saturation prepass (K4, `satcull.satcount_gathered`) reads the padded
f32 payload rows where they lie, through the sorted Gaussian index.

Gradients: PyTorch autograd differentiates everything around the kernels.
The blend's backward is kernel K2 (`blend_cuda.BlendFn`); the payload
gather's backward (`GatherExpand`) is kernel K3
(`segreduce.gather_expand_bwd`), which reads the instance cotangents
through binning's `order` map and sums them per Gaussian into row-major
payload gradients. With `forward_only=True` binning skips those maps and
the gather is a plain index, as for rendering.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import geometry
from ..utils import trace
from . import binning, blend_ref
from .blend_cuda import check_tile_shape
from .segreduce import gather_expand_bwd
from .projection import CameraParams, Projected, project

AUX_COLS = 16  # r, g, b, qw, qx, qy, qz, sx, sy, sz, (pad x6)

# sat_cull="auto" gate: the saturation prepass runs once the mean instance
# depth (k_cap / num_tiles) reaches this many slots per tile.
SAT_MIN_SLOTS_PER_TILE = 1024


class RasterizeConfig(NamedTuple):
    tile_h: int = 16
    tile_w: int = 16
    k_cap: int = 1 << 22       # raw instance capacity (tile-expanded)
    backend: str = "auto"      # 'auto' (= 'cuda': kernel K1, its plain
    #                            version on CPU tensors) | 'dense' (the
    #                            [K, H*W] spec; CPU tensors only)
    clamp_radius: int = 0      # 0 = unbounded footprint
    payload_dtype: str = "bf16"  # 'bf16' | 'f32' -- rgb/quat/scale payload
    blend_chunk: int = 256     # instances per blend batch; K1 stages
    #                            256 (binning.PAD_ALIGN), the only value
    forward_only: bool = False  # skip the backward's binning maps (render
    #                            only; gradients would then flow through a
    #                            plain index's scatter-add)
    k_pad: int = 0             # padded-layout capacity (0 = k_cap)
    cull_compact: object = "auto"  # pre-assignment cull of small rects
    #                            ("auto" = on up to binning.COMPACT_MAX_N)
    sat_cull: object = "auto"  # saturation prepass (ops/satcull.py), kernel
    #                            backend only; "auto" = on when k_cap >=
    #                            SAT_MIN_SLOTS_PER_TILE * num_tiles


class RasterOut(NamedTuple):
    rgb: torch.Tensor        # [3, H, W] (background composited)
    depth: torch.Tensor      # [1, H, W]
    cov_quat: torch.Tensor   # [4, H, W]
    cov_scale: torch.Tensor  # [3, H, W]
    alpha: torch.Tensor      # [1, H, W]
    radii: torch.Tensor      # [N] int32
    means2d: torch.Tensor    # [N, 2] pixel coords
    num_dropped: torch.Tensor  # scalar int32: instances dropped at capacity
    num_needed: torch.Tensor   # scalar int32: padded-layout slots used
    num_needed_raw: torch.Tensor  # scalar int32: raw-stream requirement


def build_payload(proj, quat_n: torch.Tensor, scales: torch.Tensor, aux_dtype):
    """The mixed-precision payload layout.

    pay_f32 [N, 8]:  means2d (0:2), conics (2:5), opacity (5), depth (6),
                     pad (7).
    pay_aux [N, 16]: rgb (0:3), quat (3:7), scale (7:10), pad (10:16), cast
                     to `aux_dtype` (round to nearest even for bf16).
    """
    n = proj.means2d.shape[0]
    dev = proj.means2d.device
    pay_f32 = torch.cat(
        [proj.means2d, proj.conics, proj.opacities[:, None],
         proj.depths[:, None], torch.zeros((n, 1), dtype=torch.float32, device=dev)],
        dim=1)
    pay_aux = torch.cat(
        [proj.rgb, quat_n, scales,
         torch.zeros((n, AUX_COLS - 10), dtype=torch.float32, device=dev)],
        dim=1).to(aux_dtype)
    return pay_f32, pay_aux


def assemble_dense_payload(pf: torch.Tensor, pa: torch.Tensor) -> torch.Tensor:
    """Expanded rows (pf [K,8], pa [K,16]) -> the [17, K] f32 spec layout."""
    pa_f = pa.to(torch.float32)
    return torch.cat(
        [pf[:, :6], pa_f[:, 0:3], pf[:, 6:7], pa_f[:, 3:10]], dim=1).T


class GatherExpand(torch.autograd.Function):
    """Expand per-Gaussian payload tables to channel-major per-instance
    rows (JAX `gather_expand`, rasterize.py:137-254).

    pay_f32 [n+1, 8] f32, pay_aux [n+1, 16] (bf16 | f32), gidx [k_pad]
    int32 -> ([8, k_pad] f32, [16, k_pad] aux dtype). `order` ([kr] int32:
    raw row -> padded slot, k_pad = dead) and `ends` ([n+1] int32: exclusive
    end of each Gaussian's rows) come from binning.

    Backward: kernel K3 (`segreduce.gather_expand_bwd`) sums each
    Gaussian's live instance cotangents into row-major [n+1, 8] f32 and
    [n+1, 16] aux-dtype gradients."""

    @staticmethod
    def forward(ctx, pay_f32, pay_aux, gidx, order, ends):
        g = gidx.long()
        ctx.save_for_backward(order, ends)
        return pay_f32[g].T.contiguous(), pay_aux[g].T.contiguous()

    @staticmethod
    def backward(ctx, d_pf, d_pa):
        order, ends = ctx.saved_tensors
        dpf, dpa = gather_expand_bwd(d_pf.contiguous(), d_pa.contiguous(),
                                     order, ends)
        return dpf, dpa, None, None, None


def _resolve_backend(config: RasterizeConfig, device: torch.device) -> str:
    backend = "cuda" if config.backend == "auto" else config.backend
    if backend not in ("dense", "cuda"):
        raise ValueError(f"unknown backend {config.backend}")
    if backend == "dense" and device.type != "cpu":
        raise ValueError("the dense spec backend runs on CPU tensors only; "
                         f"got {device} (use backend='auto')")
    if config.blend_chunk != binning.PAD_ALIGN:
        raise ValueError(f"blend_chunk={config.blend_chunk}: the blend walks "
                         f"{binning.PAD_ALIGN}-instance batches only")
    return backend


class Staged(NamedTuple):
    """Everything `rasterize` computes before the blend: the kernels'
    inputs on the main path."""
    proj: Projected
    grid: binning.TileGrid
    backend: str
    rb: binning.RawBinned
    pay_rows: torch.Tensor              # [n+1, 8] f32 payload rows; K4
    #                                     reads them through rb.gidx_sorted
    sat_counts: Optional[torch.Tensor]  # [num_tiles] K4 output (sat cull on)
    binned: binning.Binned
    payload_f32: torch.Tensor           # [8, k_pad] K1 input
    payload_aux: torch.Tensor           # [16, k_pad] K1 input (bf16 or f32)


def stage(
    means3d: torch.Tensor,               # [N, 3]
    quats: torch.Tensor,                 # [N, 4] (raw; normalized internally)
    scales: torch.Tensor,                # [N, 3] (activated)
    opacities: torch.Tensor,             # [N] or [N, 1] (activated)
    shs: Optional[torch.Tensor],         # [N, K, 3] SH coeffs (or None)
    cam: CameraParams,
    *,
    colors_precomp: Optional[torch.Tensor] = None,  # [N, 3] overrides SH
    cov6_precomp: Optional[torch.Tensor] = None,    # [N, 6] overrides cov
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    valid: Optional[torch.Tensor] = None,           # [N] bool
    means2d_offset: Optional[torch.Tensor] = None,  # [N, 2]
    config: RasterizeConfig = RasterizeConfig(),
) -> Staged:
    """Project, bin, run the saturation prepass (K4) when it is on, lay out
    and gather the payload: every stage of `rasterize` before the blend."""
    backend = _resolve_backend(config, means3d.device)
    if backend == "cuda":  # on a CPU tensor too: refuse what the card would
        check_tile_shape(config.tile_h, config.tile_w)
    H, W = cam.height, cam.width
    grid = binning.TileGrid.for_image(H, W, config.tile_h, config.tile_w)

    with trace.span("raster.project"):
        if cov6_precomp is not None:
            cov6 = cov6_precomp
        else:
            cov6 = geometry.cov6_from_scaling_rotation(scales, quats, scale_modifier)

        if colors_precomp is not None:
            # Bypass the SH path: encode the color as a DC-only SH.
            from .. import sh as sh_lib

            shs_eff = (colors_precomp - 0.5)[:, None, :] / sh_lib.C0
            deg_eff = 0
        else:
            if shs is None:
                raise ValueError("need shs or colors_precomp")
            shs_eff = shs
            deg_eff = sh_degree

        proj = project(
            means3d, cov6, opacities, shs_eff, cam,
            sh_degree=deg_eff, valid=valid, means2d_offset=means2d_offset,
            clamp_radius=config.clamp_radius,
        )

        quat_n = geometry.quat_standardize(geometry.quat_normalize(quats))
        scale_eff = scales * scale_modifier
        aux_dtype = torch.bfloat16 if config.payload_dtype == "bf16" else torch.float32
        pay_f32, pay_aux = build_payload(proj, quat_n, scale_eff, aux_dtype)

    sat_auto = config.k_cap >= SAT_MIN_SLOTS_PER_TILE * grid.num_tiles
    sat_on = (backend == "cuda"
              and (config.sat_cull if config.sat_cull != "auto" else sat_auto))
    m2d = proj.means2d.detach()
    dep = proj.depths.detach()
    con = proj.conics.detach()
    op = proj.opacities.detach()
    compact = (None if config.cull_compact == "auto"
               else bool(config.cull_compact))
    with trace.span("raster.bin"):
        rb = binning.bin_raw(m2d, dep, proj.radii_xy, grid, config.k_cap,
                             conics=con, opacities=op, compact=compact)
    with trace.span("raster.project"):
        # Dummy zero-opacity row at index n absorbs the padding slots.
        pay_f32 = F.pad(pay_f32, (0, 0, 0, 1))
        pay_aux = F.pad(pay_aux, (0, 0, 0, 1))
    pay_rows = pay_f32.detach()
    sat_counts = None
    if sat_on:
        from . import satcull

        # K4 reads each walked slot's payload row through gidx_sorted; gidx
        # of tail slots past num_real may point anywhere in [0, n], and the
        # kernel masks slots outside each tile's range. (The JAX package
        # gathers pay_f32[gidx_sorted].T first, for its TPU kernel's DMAs.)
        with trace.span("raster.satcount"):
            sat_counts = satcull.satcount_gathered(pay_rows, rb.gidx_sorted,
                                                   rb.raw_starts, grid)
    with trace.span("raster.bin"):
        binned = binning.bin_gaussians(
            m2d, dep, proj.radii_xy, grid, config.k_cap,
            conics=con, opacities=op,
            want_keys=(backend == "dense"), want_grad_maps=not config.forward_only,
            k_pad=config.k_pad, compact=compact, rb=rb, sat_counts=sat_counts)

    with trace.span("raster.gather"):
        if config.forward_only:
            gidx = binned.gidx.long()
            payload_f32 = pay_f32[gidx].T.contiguous()
            payload_aux = pay_aux[gidx].T.contiguous()
        else:
            # the dummy row n gets an empty segment
            ends = torch.cat([binned.gauss_ends, binned.gauss_ends[-1:]])
            payload_f32, payload_aux = GatherExpand.apply(
                pay_f32, pay_aux, binned.gidx, binned.order, ends)
    return Staged(proj=proj, grid=grid, backend=backend, rb=rb,
                  pay_rows=pay_rows, sat_counts=sat_counts, binned=binned,
                  payload_f32=payload_f32, payload_aux=payload_aux)


def rasterize(
    means3d: torch.Tensor,               # [N, 3]
    quats: torch.Tensor,                 # [N, 4] (raw; normalized internally)
    scales: torch.Tensor,                # [N, 3] (activated)
    opacities: torch.Tensor,             # [N] or [N, 1] (activated)
    shs: Optional[torch.Tensor],         # [N, K, 3] SH coeffs (or None)
    cam: CameraParams,
    *,
    colors_precomp: Optional[torch.Tensor] = None,  # [N, 3] overrides SH
    cov6_precomp: Optional[torch.Tensor] = None,    # [N, 6] overrides cov
    sh_degree: int = 3,
    bg: Optional[torch.Tensor] = None,   # [3]
    scale_modifier: float = 1.0,
    valid: Optional[torch.Tensor] = None,           # [N] bool
    means2d_offset: Optional[torch.Tensor] = None,  # [N, 2]
    config: RasterizeConfig = RasterizeConfig(),
) -> RasterOut:
    st = stage(means3d, quats, scales, opacities, shs, cam,
               colors_precomp=colors_precomp, cov6_precomp=cov6_precomp,
               sh_degree=sh_degree, scale_modifier=scale_modifier,
               valid=valid, means2d_offset=means2d_offset, config=config)
    H, W = cam.height, cam.width
    grid, binned = st.grid, st.binned
    with trace.span("raster.blend"):
        if st.backend == "dense":
            out = blend_ref.blend_dense(
                assemble_dense_payload(st.payload_f32.T, st.payload_aux.T),
                binned.sort_keys, binned.tile_starts, grid, H, W)
        else:
            from . import blend_cuda

            out_p = blend_cuda.BlendFn.apply(st.payload_f32, st.payload_aux,
                                             binned.tile_starts, grid,
                                             grid.padded_height,
                                             grid.padded_width)
            out = out_p[:, :H, :W]
        return raster_out(st, out, bg)


def raster_out(st: Staged, out: torch.Tensor,
               bg: Optional[torch.Tensor] = None) -> RasterOut:
    """The blend's output [12, H, W] (cropped to the image) and the stages'
    records -> RasterOut, with the background `bg` ([3], default black)
    composited behind the rgb."""
    if bg is None:
        bg = torch.zeros(3, dtype=out.dtype, device=out.device)
    t_fin = out[blend_ref.N_ACCUM]
    rgb = out[0:3] + t_fin[None] * bg[:, None, None]

    return RasterOut(
        rgb=rgb,
        depth=out[3:4],
        cov_quat=out[4:8],
        cov_scale=out[8:11],
        alpha=1.0 - t_fin[None],
        radii=st.proj.radii,
        means2d=st.proj.means2d,
        num_dropped=st.binned.num_dropped,
        num_needed=st.binned.tile_starts[-1],
        num_needed_raw=st.rb.total,
    )
