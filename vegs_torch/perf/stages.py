"""Stage-by-stage timing of the rasterizer's step at the bench workload:
port of perf/stages_r02.py.

500,000 Gaussians at 376x1408 (`refscale.build_scene`, the scene of
stages_r02.py:50-61), 16x16 tiles, k_cap 1,126,912 (stages_r02.py:28-29;
the sat-cull gate stays off there: 1,126,912 < 1024 x 2,112 slots), bf16
aux. `run` times, through the port's own functions:

- the full forward (`rasterize` with `forward_only`: the JAX script's
  jitted forward computes no backward maps either) and the full forward
  and backward of mean(rgb^2) + 0.01 mean(depth^2);
- the projection alone (forward);
- the binning alone: `bin_gaussians` with the ellipse cull, the Gaussian
  index and tile ranges only (what the JAX script's jitted sum of `gidx`
  keeps), and with the backward's maps;
- the payload gather (`GatherExpand`) forward, and forward and backward
  (K3);
- the blend (`BlendFn`) forward (K1), and forward and backward (K1+K2).

`bisect` (stages_r02.py:160) runs the forward up to each stage -- the
projection, the binning (as the JAX bisect does: without the ellipse cull),
the gather, the blend -- with a loss planted on that stage's outputs, both
forward only and forward and backward.

`bwd_bisect` (perf/r03_bwd_bisect.py) takes the same scene at k_cap 2^21
and bins without the ellipse cull (r03_bwd_bisect.py:83): forward and
backward of all five leaves with the loss planted after the projection,
the payload, the gather and the blend (r03_bwd_bisect.py:65-103); of the
means alone (:105-111); and the full forward with the blend detached and
cotangents planted on the gathered payload (:116-144). It launches K1, K2
and K3.

Each line has the stream time ("ms", CUDA events) and the card's own time
("device_ms", torch.profiler) of `timing.measure`; each `run` stage has
its bound from `roofline` (bytes once at 3.35 TB/s, fp32 operations at
67 TFLOP/s; the blend's operations counted by its plain version's pairs,
a few seconds) and its share of the device time; a share above 1 means a count
is wrong, and the run fails.

Run on the card:  python -m vegs_torch.perf.stages [bisect | bwd_bisect]
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from .. import geometry, resolve_device
from ..ops import binning, blend_cuda
from ..ops.projection import project
from ..ops.rasterize import (GatherExpand, RasterizeConfig, build_payload,
                             rasterize)
from . import roofline
from .refscale import _payload, build_scene
from .roofline import Work
from .timing import device_line, measure

H, W = 376, 1408
N = 500_000
K_CAP = 1_126_912


def _ends(binned):
    return torch.cat([binned.gauss_ends, binned.gauss_ends[-1:]])


def stage_work(n, k_cap, k_pad, tiles, hp, wp, aux_bytes, sh_coeffs,
               columns, pairs_k1) -> dict:
    """Each `run` stage's work (roofline's counts): each input read once,
    each output written once, the blend's operations per pair of this
    run's data."""
    params = 12 + 16 + 12 + 4 + sh_coeffs * 3 * 4
    proj_fwd = Work(n * (params + roofline.PROJECTED_BYTES),
                    n * roofline.PROJECT_OPS_FWD)
    proj_fb = Work(n * (2 * params + roofline.PROJECTED_BYTES),
                   n * (roofline.PROJECT_OPS_FWD + roofline.PROJECT_OPS_BWD))
    bin_idx = Work(n * roofline.BIN_IN_BYTES + 4 * k_pad + 4 * (tiles + 1), 0)
    bin_maps = bin_idx + Work(4 * k_cap + 4 * n, 0)
    row = 32 + 16 * aux_bytes
    ge_fwd = Work((n + 1) * row + 4 * k_pad + k_pad * row, 0)
    k3 = roofline.k3_fused_work(columns, n + 1, aux_bytes)
    k1 = roofline.k1_work(pairs_k1, aux_bytes, tiles, hp, wp)
    k2 = roofline.k2_work(pairs_k1, aux_bytes, k_pad, tiles, hp, wp)
    return {
        "full forward": proj_fwd + bin_idx + ge_fwd + k1,
        "full fwd+bwd": proj_fb + bin_maps + ge_fwd + k3 + k1 + k2,
        "project (forward)": proj_fwd,
        "binning (gidx and ranges)": bin_idx,
        "binning (with the backward's maps)": bin_maps,
        "gather_expand forward": ge_fwd,
        "gather_expand fwd+bwd (K3)": ge_fwd + k3,
        "blend forward (K1)": k1,
        "blend fwd+bwd (K1+K2)": k1 + k2,
    }


def run(device=None, n: int = N, h: int = H, w: int = W, k_cap: int = K_CAP,
        iters: int = 20, warmup: int = 3, emit=None) -> dict:
    """Time every stage (see the module note) on `device` (the card unless
    device="cpu"); one dict a stage to `emit` (default: a JSON line).
    Returns {"stages": {name: line}, "counts": {...}, "card": ...}."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    means, quats, scales, opac, shs = arrays
    grid = binning.TileGrid.for_image(h, w)
    hp, wp = grid.padded_height, grid.padded_width
    bg = torch.zeros(3, device=dev)
    cfg = RasterizeConfig(k_cap=k_cap)
    leaves = [x.clone().requires_grad_(True) for x in arrays]
    fns = {}

    def full_fwd():
        with torch.no_grad():
            return rasterize(*arrays, cam, bg=bg,
                             config=cfg._replace(forward_only=True))
    fns["full forward"] = full_fwd

    def full_fb():
        out = rasterize(*leaves, cam, bg=bg, config=cfg)
        loss = out.rgb.square().mean() + 0.01 * out.depth.square().mean()
        return torch.autograd.grad(loss, leaves)
    fns["full fwd+bwd"] = full_fb

    cov6 = geometry.cov6_from_scaling_rotation(scales, quats)

    def proj_only():
        with torch.no_grad():
            return project(means, cov6, opac, shs, cam)
    fns["project (forward)"] = proj_only

    with torch.no_grad():
        p = project(means, cov6, opac, shs, cam)
        geo = (p.means2d, p.depths, p.radii_xy, grid, k_cap)
        cull = {"conics": p.conics, "opacities": p.opacities}
        fns["binning (gidx and ranges)"] = lambda: binning.bin_gaussians(
            *geo, **cull, want_keys=False, want_grad_maps=False)
        fns["binning (with the backward's maps)"] = (
            lambda: binning.bin_gaussians(*geo, **cull, want_keys=False,
                                          want_grad_maps=True))
        binned = binning.bin_gaussians(*geo, **cull, want_keys=False,
                                       want_grad_maps=True)
        pf_pad, pa_pad = _payload(p, quats, scales)
        ge_args = (binned.gidx, binned.order, _ends(binned))
        fns["gather_expand forward"] = lambda: GatherExpand.apply(
            pf_pad, pa_pad, *ge_args)
        pf_e, pa_e = GatherExpand.apply(pf_pad, pa_pad, *ge_args)
    pay = [pf_pad.clone().requires_grad_(True),
           pa_pad.clone().requires_grad_(True)]

    def ge_fb():
        a, b = GatherExpand.apply(*pay, *ge_args)
        loss = (a * 1e-6).sum() + (b.float() * 1e-6).sum()
        return torch.autograd.grad(loss, pay)
    fns["gather_expand fwd+bwd (K3)"] = ge_fb

    blend_args = (binned.tile_starts, grid, hp, wp)

    def blend_fwd():
        with torch.no_grad():
            return blend_cuda.BlendFn.apply(pf_e, pa_e, *blend_args)
    fns["blend forward (K1)"] = blend_fwd
    exp = [pf_e.clone().requires_grad_(True), pa_e.clone().requires_grad_(True)]

    def blend_fb():
        out = blend_cuda.BlendFn.apply(*exp, *blend_args)
        return torch.autograd.grad(out.sum(), exp)
    fns["blend fwd+bwd (K1+K2)"] = blend_fb

    counts = {"n": n, "k_cap": k_cap, "tiles": grid.num_tiles,
              "kept": int(binned.num_instances),
              "dropped": int(binned.num_dropped),
              "padded": int(binned.tile_starts[-1])}
    pairs = {}
    with torch.no_grad():
        blend_cuda.blend_ref_tiles(pf_e, pa_e, *blend_args, pairs=pairs)
    counts["pairs_k1"] = pairs
    works = stage_work(n, k_cap, k_cap, grid.num_tiles, hp, wp,
                       pa_e.element_size(), shs.shape[1],
                       int(_ends(binned)[-1]), pairs)
    emit(counts=counts, card=card)
    stages = {}
    for name, fn in fns.items():
        line = {"stage": name, **measure(fn, dev, iters, warmup)}
        line.pop("top", None)
        b, by = roofline.bound_ms(works[name])
        line.update(bound_ms=b, bound_by=by)
        if "device_ms" in line:
            line["device_share"] = b / line["device_ms"]
            if line["device_share"] > 1:
                raise AssertionError(f"a stage runs faster than its bound: "
                                     f"a count is wrong: {line}")
        if name == "full fwd+bwd" and "ms" in line:
            line["mpixs"] = h * w / line["ms"] / 1e3
        emit(**line, card=card)
        stages[name] = line
    return {"stages": stages, "counts": counts, "card": card}


BISECT = ("project", "binning", "gather", "blend")


def bisect(device=None, n: int = N, h: int = H, w: int = W,
           k_cap: int = K_CAP, iters: int = 20, warmup: int = 3,
           emit=None) -> dict:
    """stages_r02.py:160: the forward up to each stage of BISECT with a
    loss planted on its outputs, forward only ("fwd upto <stage>") and
    forward and backward ("fwd+bwd upto <stage>"). The binning runs without
    the ellipse cull, as the JAX bisect's does. Returns {name: line}."""
    from ..ops.rasterize import AUX_COLS

    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    grid = binning.TileGrid.for_image(h, w)
    hp, wp = grid.padded_height, grid.padded_width
    leaves = [x.clone().requires_grad_(True) for x in arrays]

    def upto(stage, xs):
        m, q, s, o, sh = xs
        p = project(m, geometry.cov6_from_scaling_rotation(s, q), o, sh, cam)
        if stage == "project":
            return p.means2d.sum() + p.rgb.sum() + p.conics.sum()
        quat_n = geometry.quat_standardize(geometry.quat_normalize(q))
        nn_ = m.shape[0]
        pay_f32 = torch.cat([p.means2d, p.conics, p.opacities[:, None],
                             p.depths[:, None], m.new_zeros((nn_, 1))], 1)
        pay_aux = torch.cat([p.rgb, quat_n, s,
                             m.new_zeros((nn_, AUX_COLS - 10))],
                            1).to(torch.bfloat16)
        b = binning.bin_gaussians(p.means2d.detach(), p.depths.detach(),
                                  p.radii_xy, grid, k_cap,
                                  want_grad_maps=True)
        if stage == "binning":
            return ((b.gidx.sum() + b.tile_starts.sum()).float()
                    + pay_f32.sum() + pay_aux.float().sum())
        pf, pa = GatherExpand.apply(
            torch.nn.functional.pad(pay_f32, (0, 0, 0, 1)),
            torch.nn.functional.pad(pay_aux, (0, 0, 0, 1)), b.gidx,
            b.order, _ends(b))
        if stage == "gather":
            return pf[:, ::17].sum() + pa[:, ::17].float().sum()
        out = blend_cuda.BlendFn.apply(pf, pa, b.tile_starts, grid, hp, wp)
        return out.sum()

    lines = {}
    for stage in BISECT:
        def fwd(stage=stage):
            with torch.no_grad():
                return upto(stage, arrays)

        def fb(stage=stage):
            return torch.autograd.grad(upto(stage, leaves), leaves,
                                       allow_unused=True)

        for name, fn in ((f"fwd upto {stage}", fwd),
                         (f"fwd+bwd upto {stage}", fb)):
            line = {"stage": name, **measure(fn, dev, iters, warmup)}
            line.pop("top", None)
            emit(**line, card=card)
            lines[name] = line
    return lines


BWD_K_CAP = 1 << 21   # r03_bwd_bisect.py:28
BWD_UPTO = ("project", "payload", "gather", "blend")


def bwd_pipeline(cam, grid, k_cap: int, xs, upto: str):
    """r03_bwd_bisect.py:66-103: the step's forward to `upto` with its loss
    planted there: the sum of the projection's outputs, of the payload
    tables (the aux table summed in bf16, as JAX's jnp.sum of a bf16
    array), of the gathered payload, or the blend's mean(rgb^2) + 0.01
    mean(depth^2) over the padded image. The binning runs without the
    ellipse cull."""
    m, q, s, o, sh = xs
    p = project(m, geometry.cov6_from_scaling_rotation(s, q), o, sh, cam)
    if upto == "project":
        return (p.means2d.sum() + p.rgb.sum() + p.conics.sum()
                + p.depths.sum() + p.opacities.sum())
    quat_n = geometry.quat_standardize(geometry.quat_normalize(q))
    pay_f32, pay_aux = build_payload(p, quat_n, s, torch.bfloat16)
    if upto == "payload":
        return pay_f32.sum() + pay_aux.sum().float()
    pf, pa, b = _bwd_gathered(pay_f32, pay_aux, p, grid, k_cap)
    if upto == "gather":
        return pf.sum() + pa.sum().float()
    out = blend_cuda.BlendFn.apply(pf, pa, b.tile_starts, grid,
                                   grid.padded_height, grid.padded_width)
    return out[0:3].square().mean() + 0.01 * out[3:4].square().mean()


def _bwd_gathered(pay_f32, pay_aux, p, grid, k_cap):
    b = binning.bin_gaussians(p.means2d.detach(), p.depths.detach(),
                              p.radii_xy, grid, k_cap, want_grad_maps=True)
    pf, pa = GatherExpand.apply(F.pad(pay_f32, (0, 0, 0, 1)),
                                F.pad(pay_aux, (0, 0, 0, 1)), b.gidx,
                                b.order, _ends(b))
    return pf, pa, b


def skip_blend_bwd_loss(cam, grid, k_cap: int, xs):
    """r03_bwd_bisect.py:116-140: the full forward with the blend fed the
    gathered payload detached (its forward kept, its backward skipped) and
    the payload's cotangents planted by 1e-9 of its sums."""
    m, q, s, o, sh = xs
    p = project(m, geometry.cov6_from_scaling_rotation(s, q), o, sh, cam)
    quat_n = geometry.quat_standardize(geometry.quat_normalize(q))
    pay_f32, pay_aux = build_payload(p, quat_n, s, torch.bfloat16)
    pf, pa, b = _bwd_gathered(pay_f32, pay_aux, p, grid, k_cap)
    out = blend_cuda.BlendFn.apply(pf.detach(), pa.detach(), b.tile_starts,
                                   grid, grid.padded_height,
                                   grid.padded_width)
    return (out[0:3].square().mean() + pf.sum() * 1e-9
            + pa.sum().float() * 1e-9)


def bwd_lines(cam, grid, k_cap: int, arrays) -> dict:
    """{line name: fn() -> (loss, gradients)} of `bwd_bisect`; the
    gradients of the leaves the line differentiates."""
    leaves = [x.clone().requires_grad_(True) for x in arrays]

    def fb(loss_of, wrt):
        def fn():
            loss = loss_of(leaves)
            return loss, torch.autograd.grad(loss, [leaves[i] for i in wrt])
        return fn

    every = range(5)
    lines = {f"fwd+bwd(all params) upto {u}": fb(
        lambda xs, u=u: bwd_pipeline(cam, grid, k_cap, xs, u), every)
        for u in BWD_UPTO}
    lines["fwd+bwd(means only) upto blend"] = fb(
        lambda xs: bwd_pipeline(cam, grid, k_cap, xs, "blend"), (0,))
    lines["fwd(full)+bwd skipping blend-bwd"] = fb(
        lambda xs: skip_blend_bwd_loss(cam, grid, k_cap, xs), every)
    return lines


def bwd_bisect(device=None, n: int = N, h: int = H, w: int = W,
               k_cap: int = BWD_K_CAP, iters: int = 20, warmup: int = 3,
               emit=None) -> dict:
    """r03_bwd_bisect.py's lines (`bwd_lines`) on the 500k scene, each
    with its loss, whether every gradient is finite, and the binning's
    kept and dropped instances. Returns {name: line}."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    grid = binning.TileGrid.for_image(h, w)
    with torch.no_grad():
        m, q, s, o, sh = arrays
        p = project(m, geometry.cov6_from_scaling_rotation(s, q), o, sh, cam)
        b = binning.bin_gaussians(p.means2d, p.depths, p.radii_xy, grid,
                                  k_cap)
        counts = {"n": n, "k_cap": k_cap, "kept": int(b.num_instances),
                  "dropped": int(b.num_dropped)}
    emit(probe="bwd_bisect", counts=counts, card=card)
    lines = {}
    for name, fn in bwd_lines(cam, grid, k_cap, arrays).items():
        loss, grads = fn()
        line = {"probe": "bwd_bisect", "stage": name,
                "loss": float(loss.detach()),
                "finite": bool(torch.isfinite(loss)) and all(
                    bool(torch.isfinite(g).all()) for g in grads),
                **measure(fn, dev, iters, warmup)}
        line.pop("top", None)
        emit(**line, card=card)
        lines[name] = line
    return {"lines": lines, "counts": counts, "card": card}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "bwd_bisect" in argv:
        bwd_bisect()
    elif "bisect" in argv:
        bisect()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
