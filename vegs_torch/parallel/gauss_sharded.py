"""Gaussian-axis (N) sharding of the rasterizer front end (port of
vegs_tpu/parallel/gauss_sharded.py).

The field lives sharded over a "gauss" mesh axis: each rank projects its own
row block (cull, EWA conic, SH colour: the N-proportional work) and builds
the compact payload rows (8 f32 + 16 aux columns, 64 B a Gaussian with bf16
aux); the rows are all-gathered, and binning, the gather (K3 in its
backward) and the blend (K1, K2) run replicated on the gathered stream,
equal to the bit to the single-device `rasterize` (the sat cull, lossless,
is not run here, as in the JAX package, so the padded layout needs more
than the sat-culled main path's: `config.k_pad`, 0 = k_cap, sizes it). The gather carries a gradient
(`comm.all_gather`), so each rank's rows get their cotangents back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import geometry
from ..ops import binning, blend_ref
from ..ops.projection import CameraParams, project
from ..ops.rasterize import (GatherExpand, RasterizeConfig,
                             _resolve_backend, assemble_dense_payload,
                             build_payload)
from .comm import all_gather
from .mesh import Mesh, make_mesh

GAUSS_AXIS = "gauss"


def make_gauss_mesh(n_devices: int) -> Mesh:
    return make_mesh(n_devices, GAUSS_AXIS)


def shard_rows(x, index: int, n: int):
    """Row block `index` of `n` of x (rows must split evenly)."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks; "
                         "pad the capacity")
    m = x.shape[0] // n
    return x[index * m:(index + 1) * m]


def shard_field_arrays(mesh: Mesh, *arrays):
    """This rank's row block of each per-Gaussian array, over the mesh's
    first axis (leading dims must divide the axis size)."""
    comm = mesh.comm()
    return tuple(shard_rows(a, comm.index, comm.size) for a in arrays)


def make_gauss_sharded_rasterize(mesh: Mesh, cam: CameraParams,
                                 config: RasterizeConfig, sh_degree: int = 3):
    """fn(means, quats, scales, opac, shs, valid, bg) -> (rgb [3, H, W],
    depth [1, H, W], alpha [1, H, W]) whose per-Gaussian inputs are this
    rank's row block; the images are the same on every rank and equal to
    the bit to the single-device `rasterize`."""
    comm = mesh.comm()
    H, W = cam.height, cam.width

    def fn(means, quats, scales, opac, shs, valid, bg):
        backend = _resolve_backend(config, means.device)
        # -- sharded front end: N-proportional work on N/D rows ----------
        cov6 = geometry.cov6_from_scaling_rotation(scales, quats)
        proj = project(means, cov6, opac, shs, cam, sh_degree=sh_degree,
                       valid=valid, clamp_radius=config.clamp_radius)
        quat_n = geometry.quat_standardize(geometry.quat_normalize(quats))
        aux_dtype = (torch.bfloat16 if config.payload_dtype == "bf16"
                     else torch.float32)
        pay_f32, pay_aux = build_payload(proj, quat_n, scales, aux_dtype)

        # -- gather the compact rows; binning and blend replicated ---------
        pay_f32 = all_gather(pay_f32, comm)
        pay_aux = all_gather(pay_aux, comm)
        radii_xy = all_gather(proj.radii_xy, comm)
        # binning's inputs are columns of the gathered rows (means2d 0:2,
        # conics 2:5, opacity 5, depth 6): no second gather of the same data
        pf = pay_f32.detach()
        grid = binning.TileGrid.for_image(H, W, config.tile_h, config.tile_w)
        compact = (None if config.cull_compact == "auto"
                   else bool(config.cull_compact))
        b = binning.bin_gaussians(
            pf[:, 0:2], pf[:, 6], radii_xy, grid, config.k_cap,
            conics=pf[:, 2:5], opacities=pf[:, 5],
            want_keys=(backend == "dense"), want_grad_maps=True,
            k_pad=config.k_pad, compact=compact)
        ends = torch.cat([b.gauss_ends, b.gauss_ends[-1:]])
        pf_e, pa_e = GatherExpand.apply(
            F.pad(pay_f32, (0, 0, 0, 1)), F.pad(pay_aux, (0, 0, 0, 1)),
            b.gidx, b.order, ends)
        if backend == "dense":
            out = blend_ref.blend_dense(
                assemble_dense_payload(pf_e.T, pa_e.T), b.sort_keys,
                b.tile_starts, grid, H, W)
        else:
            from ..ops import blend_cuda

            out = blend_cuda.BlendFn.apply(
                pf_e, pa_e, b.tile_starts, grid, grid.padded_height,
                grid.padded_width)[:, :H, :W]
        t_fin = out[blend_ref.N_ACCUM]
        rgb = out[0:3] + t_fin[None] * bg[:, None, None]
        return rgb, out[3:4], 1.0 - t_fin[None]

    return fn


FIELD_PARAMS = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                "opacity_logit")


def sharded_state_bytes(field, n_devices: int) -> dict:
    """Per-rank memory, analytic: the field and its two Adam moments
    sharded over n_devices ranks (plus the transient gathered payload rows,
    64 B a Gaussian) against replicated."""
    field_bytes = sum(getattr(field, k).nelement()
                      * getattr(field, k).element_size() for k in FIELD_PARAMS)
    full = field_bytes * 3  # params + Adam mu + nu
    payload = field.capacity * 64
    return {"replicated_bytes": full,
            "sharded_bytes": full // n_devices + payload,
            "ratio": full / (full / n_devices + payload)}
