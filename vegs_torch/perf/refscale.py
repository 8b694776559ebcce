"""The rasterizer's training step split into stages at the reference's
scale: port of perf/r09_refscale.py.

2,233,571 Gaussians (the reference's recorded mid-training size) at
376x1408, placed in the frustum so nearly all are visible, capacities sized
by a probe (+5%, rounded to 512) with no instance dropped. Each stage runs
through the port's own functions: the full forward and backward (with
Mpix/s) and the full forward, per tile shape; then, at 16x16 tiles, the
projection's forward and backward, `bin_gaussians` with the backward's
maps, `bin_raw`, the sort at k_cap, K4 as the main path runs it (reading
the payload rows through the sorted Gaussian index), the sat-cull prepass
gather and K4 on its channel-major output (the JAX package's layout, which
r09 times and the main path no longer pays), the payload gather
(`GatherExpand`) forward and forward+backward (K3), and the blend forward
(K1) and forward+backward (K1+K2). On the card each stage
has its stream time ("ms", CUDA events), the card's own time ("device_ms",
torch.profiler), the device operations it launches per call and the three
that take the most device time (`timing.measure`). Two lines of instance
statistics follow. With `work=True` it also counts, with the kernels'
plain versions, the pairs the blend and K4 walk, for `roofline`.

Run on the card:  python -m vegs_torch.perf.refscale
Settings (r09's names): VEGS_R09_N (default 2233571), VEGS_R09_TILES
(default 16x16; e.g. 16x16,16x32), VEGS_R09_SAT (default 1; 0 = sat cull
off).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import geometry, resolve_device
from ..ops import binning, blend_cuda, satcull
from ..ops.projection import project
from ..ops.rasterize import (GatherExpand, RasterizeConfig, build_payload,
                             rasterize)
from .timing import device_line, measure

H, W = 376, 1408
N_REF = 2_233_571
SEED = 0
PROBE_CAP = (1 << 23) - 512  # raw capacity of the sizing probe


def r512(v: float) -> int:
    return (int(v) + 511) // 512 * 512


def random_gaussians(rng, n, depth_range, xy_extent, scale_range,
                     opacity_range=(0.2, 0.95)):
    """Random cloud in front of a camera at the origin looking down +z
    (the distribution of the JAX package's tests/utils.py)."""
    means = np.stack([
        rng.uniform(-xy_extent, xy_extent, n),
        rng.uniform(-xy_extent * 0.6, xy_extent * 0.6, n),
        rng.uniform(*depth_range, n)], axis=1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    opac = rng.uniform(*opacity_range, n).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.0, 1.5, (n, 3))
    shs[:, 1:] = rng.normal(0, 0.12, (n, 15, 3))
    return means, quats, scales, opac, shs


def origin_camera(h, w, fovx, fovy, device):
    """A camera at the origin looking down +z (tests/utils.make_camera)."""
    from ..convert import camera_params_from_numpy

    view = geometry.world_to_view(np.eye(3), np.zeros(3))
    full = geometry.projection_matrix(0.01, 100.0, fovx, fovy) @ view
    return camera_params_from_numpy(
        view.T, full.T, np.linalg.inv(view)[:3, 3], np.tan(fovx * 0.5),
        np.tan(fovy * 0.5), h, w, device=device)


def build_scene(n: int = N_REF, h: int = H, w: int = W, device=None,
                rng=None):
    """r09's scene (r09:63-75, bench.py:75-86): the tests/utils.py draws
    from seed 0 (or from `rng`, which a caller may go on drawing from, as
    r07_shard_pallas.py:145 does), then the means re-drawn to fill the
    376x1408 frustum (fovx 1.2, fovy 0.4). Returns (camera, [means, quats,
    scales, opacities, shs])."""
    dev = resolve_device(device)
    cam = origin_camera(h, w, 1.2, 0.4, dev)
    rng = np.random.default_rng(SEED) if rng is None else rng
    means, quats, scales, opac, shs = random_gaussians(
        rng, n, depth_range=(2.0, 60.0), xy_extent=40.0,
        scale_range=(0.002, 0.025))
    z = np.asarray(rng.uniform(2.0, 60.0, n), np.float32)
    u = rng.uniform(-0.95, 0.95, n)
    v = rng.uniform(-0.95, 0.95, n)
    means = np.stack([z * np.tan(0.6) * u, z * np.tan(0.2) * v, z],
                     axis=1, dtype=np.float32)
    return cam, [torch.from_numpy(x).to(dev)
                 for x in (means, quats, scales, opac, shs)]


def _payload(proj, quats, scales):
    quat_n = geometry.quat_standardize(geometry.quat_normalize(quats))
    pay_f32, pay_aux = build_payload(proj, quat_n, scales, torch.bfloat16)
    return F.pad(pay_f32, (0, 0, 0, 1)), F.pad(pay_aux, (0, 0, 0, 1))


def _prepass(pf_pad, rb):
    """The JAX package's K4 input: the f32 payload rows in sorted order,
    channel-major (vegs_tpu/ops/rasterize.py:363-365). The port's main path
    does not build it."""
    return pf_pad[rb.gidx_sorted.long()].T.contiguous()


class Caps(NamedTuple):
    grid: binning.TileGrid
    k_cap: int
    k_pad: int
    need_raw: int
    need_pad: int


def size_caps(cam, arrays, tile_h: int = 16, tile_w: int = 16,
              sat: bool = True) -> Caps:
    """r09:78-106: bin at PROBE_CAP (the sat cull on unless `sat` is
    False), size k_cap and k_pad at the raw and padded needs + 5% rounded
    up to 512, then bin again at those capacities and raise if any
    instance is dropped."""
    probe_cap = PROBE_CAP
    means, quats, scales, opac, shs = arrays
    grid = binning.TileGrid.for_image(cam.height, cam.width, tile_h, tile_w)
    with torch.no_grad():
        proj = project(means, geometry.cov6_from_scaling_rotation(scales, quats),
                       opac, shs, cam)
        pf_pad = _payload(proj, quats, scales)[0]

        def binned(k_cap, k_pad):
            rb = binning.bin_raw(proj.means2d, proj.depths, proj.radii_xy,
                                 grid, k_cap, conics=proj.conics,
                                 opacities=proj.opacities)
            counts = (satcull.satcount_gathered(pf_pad, rb.gidx_sorted,
                                                rb.raw_starts, grid)
                      if sat else None)
            return rb, binning.bin_gaussians(
                proj.means2d, proj.depths, proj.radii_xy, grid, k_cap,
                conics=proj.conics, opacities=proj.opacities,
                want_keys=False, k_pad=k_pad, rb=rb, sat_counts=counts)

        rb, pb = binned(probe_cap, probe_cap)
        need_raw, need_pad = int(rb.total), int(pb.tile_starts[-1])
        if need_raw > probe_cap:
            raise AssertionError(f"probe capacity {probe_cap} < need {need_raw}")
        k_cap = min(probe_cap, r512(need_raw * 1.05))
        k_pad = min(probe_cap, r512(need_pad * 1.05))
        dropped = int(binned(k_cap, k_pad)[1].num_dropped)
    if dropped:
        raise AssertionError(f"{dropped} instances dropped at k_cap={k_cap}, "
                             f"k_pad={k_pad}")
    return Caps(grid, k_cap, k_pad, need_raw, need_pad)


def env_settings() -> dict:
    """r09's settings from the environment."""
    return {"n": int(os.environ.get("VEGS_R09_N", str(N_REF))),
            "tiles": tuple(os.environ.get("VEGS_R09_TILES", "16x16").split(",")),
            "sat": os.environ.get("VEGS_R09_SAT", "1") != "0"}


def run(device=None, n: int = N_REF, h: int = H, w: int = W,
        tiles=("16x16",), sat: bool = True, iters: int = 20, warmup: int = 3,
        work: bool = False, emit=None) -> dict:
    """Time every stage (see the module note) on `device` (the card unless
    device="cpu") and emit one dict per stage and statistic. Returns
    {"stages": {name: `timing.measure`'s dict}, "counts": {...}, "card":
    ...};
    with `work`, the counts hold the pairs the blend and K4 walk."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    bg = torch.zeros(3, device=dev)
    leaves = [x.clone().requires_grad_(True) for x in arrays]
    stages = {}

    def timed(name, fn, **note):
        t = measure(fn, dev, iters, warmup)
        stages[name] = t
        emit(stage=name, **t, **note, card=card)
        return t

    caps = {}
    for spec in tiles:
        th, tw = (int(x) for x in spec.split("x"))
        c = caps[spec] = size_caps(cam, arrays, th, tw, sat)
        emit(caps=spec, sat=sat, need_raw=c.need_raw, k_cap=c.k_cap,
             need_pad=c.need_pad, k_pad=c.k_pad, card=card)
        cfg = RasterizeConfig(k_cap=c.k_cap, k_pad=c.k_pad, tile_h=th,
                              tile_w=tw, sat_cull=sat)

        def full_fb(cfg=cfg):
            out = rasterize(*leaves, cam, bg=bg, config=cfg)
            loss = out.rgb.square().mean() + 0.01 * out.depth.square().mean()
            return torch.autograd.grad(loss, leaves)

        def full_fwd(cfg=cfg):
            with torch.no_grad():
                return rasterize(*arrays, cam, bg=bg,
                                 config=cfg._replace(forward_only=True))

        t = timed(f"[{spec}] full fwd+bwd", full_fb)
        if "ms" in t:
            emit(stage=f"[{spec}] full fwd+bwd Mpix/s",
                 mpix_s=h * w / t["ms"] / 1e3, card=card)
        timed(f"[{spec}] full forward", full_fwd)

    # -- the stages one by one, at 16x16 tiles -------------------------------
    c = caps.get("16x16") or size_caps(cam, arrays, 16, 16, sat)
    grid, k_cap, k_pad = c.grid, c.k_cap, c.k_pad
    means, quats, scales, opac, shs = arrays

    def proj_fb():
        m, q, s, o, sh = leaves
        p = project(m, geometry.cov6_from_scaling_rotation(s, q), o, sh, cam)
        loss = ((p.means2d * 1e-6).sum() + (p.rgb * 1e-6).sum()
                + (p.conics * 1e-9).sum())
        return torch.autograd.grad(loss, leaves, allow_unused=True)
    timed("project (+cov6) fwd+bwd", proj_fb)

    with torch.no_grad():
        p = project(means, geometry.cov6_from_scaling_rotation(scales, quats),
                    opac, shs, cam)
        geo = (p.means2d, p.depths, p.radii_xy, grid)
        cull = {"conics": p.conics, "opacities": p.opacities}
        timed("bin_gaussians (grad maps, no keys)",
              lambda: binning.bin_gaussians(*geo, k_cap, **cull,
                                            want_keys=False,
                                            want_grad_maps=True, k_pad=k_pad))
        timed("bin_raw (expand+cull+sort)",
              lambda: binning.bin_raw(*geo, k_cap, **cull))

        keys = torch.from_numpy(np.random.default_rng(1).integers(
            0, 2**30, size=k_cap, dtype=np.int32)).to(dev)
        vals = torch.arange(k_cap, dtype=torch.int32, device=dev)

        def sort_only():
            _, perm = torch.sort(keys, stable=True)
            return vals[perm], vals[perm]
        timed("sort at k_cap (stable, 2 gathers)", sort_only)

        rb = binning.bin_raw(*geo, k_cap, **cull)
        pf_pad, pa_pad = _payload(p, quats, scales)
        k4_args = (pf_pad, rb.gidx_sorted, rb.raw_starts, grid)
        timed("K4 satcount", lambda: satcull.satcount_gathered(*k4_args))
        sat_counts = satcull.satcount_gathered(*k4_args)
        jax_layout = {"note": "the JAX package's layout; the main path no "
                              "longer runs it"}
        timed("satcull prepass gather", lambda: _prepass(pf_pad, rb),
              **jax_layout)
        pf_sorted = _prepass(pf_pad, rb)
        timed("K4 satcount, channel-major",
              lambda: satcull.satcount(pf_sorted, rb.raw_starts, grid),
              **jax_layout)
        del pf_sorted
        raw_counts = rb.raw_starts[1:] - rb.raw_starts[:-1]
        emit(stat="satcull keeps",
             kept=int(torch.minimum(sat_counts, raw_counts).sum()),
             real=int(rb.num_real), card=card)

        binned = binning.bin_gaussians(
            *geo, k_cap, **cull, want_keys=False, want_grad_maps=True,
            k_pad=k_pad, rb=rb if sat else None,
            sat_counts=sat_counts if sat else None)
        ends = torch.cat([binned.gauss_ends, binned.gauss_ends[-1:]])
        ge_args = (binned.gidx, binned.order, ends)
        timed("GatherExpand fwd",
              lambda: GatherExpand.apply(pf_pad, pa_pad, *ge_args))
        pf_e, pa_e = GatherExpand.apply(pf_pad, pa_pad, *ge_args)

    pay = [pf_pad.clone().requires_grad_(True),
           pa_pad.clone().requires_grad_(True)]

    def ge_fb():
        a, b = GatherExpand.apply(*pay, *ge_args)
        loss = a.sum() * 1e-9 + b.float().sum() * 1e-9
        return torch.autograd.grad(loss, pay)
    timed("GatherExpand fwd+bwd (K3)", ge_fb)

    ts = binned.tile_starts
    hp, wp = grid.padded_height, grid.padded_width
    blend_args = (ts, grid, hp, wp)

    def blend_fwd():
        with torch.no_grad():
            return blend_cuda.BlendFn.apply(pf_e, pa_e, *blend_args)
    timed("K1 blend fwd", blend_fwd)

    exp = [pf_e.clone().requires_grad_(True), pa_e.clone().requires_grad_(True)]

    def blend_fb():
        out = blend_cuda.BlendFn.apply(*exp, *blend_args)
        return torch.autograd.grad(out[:3].square().mean(), exp)
    timed("K1+K2 blend fwd+bwd", blend_fb)

    nk = int(binned.num_instances)
    emit(stat="kept instances", kept=nk, tiles=grid.num_tiles,
         per_tile=nk / grid.num_tiles, per_pixel=nk / (h * w), card=card)

    counts = {"n": n, "k_cap": k_cap, "k_pad": k_pad, "tiles": grid.num_tiles,
              "hp": hp, "wp": wp, "aux_bytes": pa_e.element_size(),
              "sh_coeffs": shs.shape[1], "columns": int(ends[-1]), "sat": sat,
              "need_raw": c.need_raw, "need_pad": c.need_pad}
    if work:
        with torch.no_grad():
            counts["pairs_k1"], counts["pairs_k4"] = {}, {}
            blend_cuda.blend_ref_tiles(pf_e, pa_e, *blend_args,
                                       pairs=counts["pairs_k1"])
            satcull.satcount_gathered_ref(*k4_args, pairs=counts["pairs_k4"])
    return {"stages": stages, "counts": counts, "card": card}


if __name__ == "__main__":
    run(**env_settings())
