"""The plain reference renderer: 3D Gaussian splatting written out as
plain PyTorch over (pixel, Gaussian) pairs, in float64, differentiable by
autograd. It shares no code with the program.

Semantics (the 3DGS rasterizer as the configuration states it):
  * view point p = W [x, 1]; a Gaussian is culled unless p.z > 0.2, its
    2D covariance is positive definite and its footprint touches the
    image; pixel centre of a 2D mean: ((ndc + 1) * size - 1) / 2, with
    clip w + 1e-7 as the divisor;
  * 2D covariance J W Sigma W^T J^T + 0.3 I, J the perspective Jacobian at
    the view point with x/z and y/z clamped to 1.3 tan(fov / 2);
  * footprint: per axis ceil(b * sqrt(cov_axis)) pixels, b = min(3,
    sqrt(2 ln(255 opacity))); the Gaussian lands in each 16x16 tile (the
    tile grid's width rounded up to 8 tiles) its footprint's rectangle
    touches;
  * colour: SH up to the active degree at the unit direction from the
    camera centre, + 0.5, clamped below at 0;
  * per pixel (integer coordinates), the Gaussians of its tile in
    increasing order of their depth's float32 bits shifted right by 12
    (ties by index): q = a dx^2 + 2 b dx dy + c dy^2 (the conic), alpha =
    min(0.99, opacity exp(-q / 2)), skipped when alpha < 1/255; a pixel
    stops before the first Gaussian that would take its transmittance T
    below 1e-4; out += payload alpha T, T *= 1 - alpha;
  * payload: rgb, view depth, the normalized rotation (w >= 0) and the
    scales; `aux_dtype` bfloat16 rounds rgb, rotation and scales to
    bfloat16 (nearest even) first, as the configuration states.

Pairs are enumerated per Gaussian over the pixels of its tile rectangle
that lie within the box where alpha can reach 1/255, then kept where it
does. `lowp` is the correctness control: the pair arithmetic's float32
inputs (2D means, conics, opacities, depths) rounded to bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cameras import View

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

TILE = 16
NTX_ALIGN = 8
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
CHUNK = 1 << 25        # candidate pairs enumerated at once
BLEND_CHUNK = 1 << 22  # pairs blended at once (whole pixels)


class Projected(NamedTuple):
    m2d: torch.Tensor      # [n, 2]
    depth: torch.Tensor    # [n]
    conic: torch.Tensor    # [n, 3] (a, b, c)
    cov: torch.Tensor      # [n, 2] (cov_xx, cov_yy), detached
    opacity: torch.Tensor  # [n]
    rgb: torch.Tensor      # [n, 3]
    quat: torch.Tensor     # [n, 4]
    scale: torch.Tensor    # [n, 3]
    radius: torch.Tensor   # [n] int64, 0 where culled
    rxy: torch.Tensor      # [n, 2] int64 per-axis footprint
    visible: torch.Tensor  # [n] bool


def sh_rgb(sh: torch.Tensor, d: torch.Tensor, degree: int) -> torch.Tensor:
    """sh [n, 16, 3] at unit directions d [n, 3] -> [n, 3]."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = C0 * sh[:, 0]
    if degree >= 1:
        out = out - C1 * y * sh[:, 1] + C1 * z * sh[:, 2] - C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out = (out + C2[0] * x * y * sh[:, 4] + C2[1] * y * z * sh[:, 5]
               + C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + C2[3] * x * z * sh[:, 7] + C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + C3[1] * x * y * z * sh[:, 10]
               + C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + C3[5] * z * (xx - yy) * sh[:, 14]
               + C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return out


def rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [..., 4] (w, x, y, z) -> rotation matrices."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-24))


def arrays(p: dict) -> dict:
    """Raw leaves (means, quats, log_scales, sh_dc, sh_rest, opacity_logit)
    -> activated arrays (means, unit quats, scales, opacity, sh [n, 16, 3])."""
    return {"means": p["means"], "quats": normalize(p["quats"]),
            "scales": torch.exp(p["log_scales"]),
            "opacity": torch.sigmoid(p["opacity_logit"][:, 0]),
            "sh": torch.cat([p["sh_dc"], p["sh_rest"]], 1)}


def project(p: dict, view: View, degree: int = 3) -> Projected:
    """The Gaussians of the raw leaves `p` seen by `view`."""
    return project_arrays(arrays(p), view, degree)


def project_arrays(p: dict, view: View, degree: int = 3) -> Projected:
    """The Gaussians of activated arrays `p` (float64) seen by `view`."""
    dev = p["means"].device
    w2c = torch.as_tensor(view.w2c, dtype=torch.float64, device=dev)
    proj = torch.as_tensor(view.proj, dtype=torch.float64, device=dev)
    x = p["means"]
    pv = x @ w2c[:3, :3].T + w2c[:3, 3]
    clip = pv @ proj[:, :3].T + proj[:, 3]
    ndc = clip[:, :2] / (clip[:, 3:4] + 1e-7)
    size = torch.tensor([view.width, view.height], dtype=torch.float64,
                        device=dev)
    m2d = ((ndc + 1) * size - 1) * 0.5
    z = pv[:, 2]

    q = normalize(p["quats"])
    scale = p["scales"]
    r = rotmat(q)
    m = r * scale[:, None, :]
    sigma = m @ m.transpose(1, 2)
    limx = 1.3 * view.width / (2 * view.fx)
    limy = 1.3 * view.height / (2 * view.fy)
    tx = torch.clamp(pv[:, 0] / z, -limx, limx) * z
    ty = torch.clamp(pv[:, 1] / z, -limy, limy) * z
    zero = torch.zeros_like(z)
    jac = torch.stack([
        torch.stack([view.fx / z, zero, -view.fx * tx / (z * z)], -1),
        torch.stack([zero, view.fy / z, -view.fy * ty / (z * z)], -1)], -2)
    t = jac @ w2c[:3, :3]
    cov = t @ sigma @ t.transpose(1, 2)
    cxx = cov[:, 0, 0] + 0.3
    cxy = cov[:, 0, 1]
    cyy = cov[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    det_ok = det > 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)

    op = p["opacity"]
    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        b = torch.clamp(torch.sqrt(2 * torch.log(
            torch.clamp(255 * op, min=1 + 1e-6))), max=3.0)
        radius = torch.ceil(b * torch.sqrt(lam))
        rxy = torch.ceil(b[:, None] * torch.sqrt(torch.stack([cxx, cyy], -1)))
        mx, my = m2d[:, 0], m2d[:, 1]
        visible = ((z > 0.2) & det_ok & (mx + radius >= 0)
                   & (mx - radius < view.width) & (my + radius >= 0)
                   & (my - radius < view.height))
        radius = torch.where(visible, radius, torch.zeros_like(radius)).long()
        rxy = torch.where(visible[:, None], rxy, torch.zeros_like(rxy)).long()

    d = x - torch.as_tensor(view.center, dtype=torch.float64, device=dev)
    d = d / torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-24))
    rgb = torch.clamp(sh_rgb(p["sh"], d, degree) + 0.5, min=0.0)
    qs = torch.where(q[:, :1] < 0, -q, q)
    return Projected(m2d, z, conic, torch.stack([cxx, cyy], -1).detach(), op,
                     rgb, qs, scale, radius, rxy, visible)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class Image(NamedTuple):
    rgb: torch.Tensor    # [3, H, W]
    depth: torch.Tensor  # [1, H, W]
    quat: torch.Tensor   # [4, H, W]
    scale: torch.Tensor  # [3, H, W]
    alpha: torch.Tensor  # [1, H, W]
    pairs: dict          # tested, included, slots, instances


def _pairs(pr: Projected, height: int, width: int, row0: int, row1: int):
    """(Gaussian, pixel) index pairs with alpha >= 1/255 inside each
    Gaussian's tile rectangle, on the image rows [row0, row1), unsorted
    (no gradient)."""
    dev = pr.m2d.device
    ntx = -(-width // TILE)
    ntx = -(-ntx // NTX_ALIGN) * NTX_ALIGN
    nty = -(-height // TILE)
    g_all = torch.nonzero(pr.visible & (pr.opacity * 255 > 1)).flatten()
    m = pr.m2d.detach()[g_all]
    dmax = 2 * torch.log(255 * pr.opacity.detach()[g_all])
    hy = torch.sqrt(dmax * pr.cov[g_all, 1]) + 1
    near = (m[:, 1] + hy >= row0) & (m[:, 1] - hy <= row1 - 1)
    g_all, m, dmax, hy = g_all[near], m[near], dmax[near], hy[near]
    rx = pr.rxy[g_all, 0].double()
    ry = pr.rxy[g_all, 1].double()
    x0 = torch.clamp(torch.floor((m[:, 0] - rx) / TILE), 0, ntx - 1)
    y0 = torch.clamp(torch.floor((m[:, 1] - ry) / TILE), 0, nty - 1)
    x1 = torch.clamp(torch.floor((m[:, 0] + rx + TILE - 1) / TILE) - 1, 0, ntx - 1)
    y1 = torch.clamp(torch.floor((m[:, 1] + ry + TILE - 1) / TILE) - 1, 0, nty - 1)
    hx = torch.sqrt(dmax * pr.cov[g_all, 0]) + 1
    px0 = torch.maximum(x0 * TILE, torch.ceil(m[:, 0] - hx)).clamp(min=0).long()
    px1 = torch.minimum((x1 + 1) * TILE - 1, torch.floor(m[:, 0] + hx)).clamp(max=width - 1).long()
    py0 = torch.maximum(y0 * TILE, torch.ceil(m[:, 1] - hy)).clamp(min=row0).long()
    py1 = torch.minimum((y1 + 1) * TILE - 1, torch.floor(m[:, 1] + hy)).clamp(max=row1 - 1).long()
    bw = (px1 - px0 + 1).clamp(min=0)
    bh = (py1 - py0 + 1).clamp(min=0)
    count = bw * bh
    ends = torch.cumsum(count, 0)
    keep_g = [g_all[:0]]
    keep_p = [g_all[:0]]
    con = pr.conic.detach()
    op = pr.opacity.detach()
    start = 0
    while start < len(g_all):
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(ends, base + CHUNK, right=True))
        stop = max(stop, start + 1)
        sl = slice(start, stop)
        c = count[sl]
        idx = torch.repeat_interleave(torch.arange(start, stop, device=dev), c)
        local = torch.arange(int(c.sum()), device=dev) - torch.repeat_interleave(
            ends[sl] - c - base, c)
        px = px0[idx] + local % bw[idx]
        py = py0[idx] + torch.div(local, bw[idx], rounding_mode="floor")
        g = g_all[idx]
        dx = px.double() - m[idx, 0]
        dy = py.double() - m[idx, 1]
        a, b, cc = con[g, 0], con[g, 1], con[g, 2]
        power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
        ok = (power <= 0) & (op[g] * torch.exp(power) >= ALPHA_MIN)
        keep_g.append(g[ok])
        keep_p.append((py * width + px)[ok])
        start = stop
    return torch.cat(keep_g), torch.cat(keep_p), ntx


class Sorted(NamedTuple):
    """The pairs in blending order and pixel-aligned ranges of them."""

    g: torch.Tensor      # [P] Gaussian of each pair
    pix: torch.Tensor    # [P] pixel (row-major) of each pair
    ranges: list         # [(lo, hi)] covering [0, P), each whole pixels
    ntx: int


def sort_pairs(pr: Projected, height: int, width: int, row0: int,
               row1: int) -> Sorted:
    """The (pixel, Gaussian) pairs of rows [row0, row1) ordered by pixel,
    then by the depth key, then by Gaussian index (no gradient)."""
    with torch.no_grad():
        g, pix, ntx = _pairs(pr, height, width, row0, row1)
        if len(pr.m2d) >= 1 << 22 or height * width >= 1 << 22:
            raise ValueError("sort key overflow")
        dkey = pr.depth.detach().float()[g].contiguous().view(torch.int32) >> 12
        key = (pix << 41) | (dkey.long() << 22) | g
        order = torch.sort(key).indices
        g, pix = g[order], pix[order]
        first = torch.ones_like(pix, dtype=torch.bool)
        first[1:] = pix[1:] != pix[:-1]
        starts = torch.nonzero(first).flatten().tolist() + [len(pix)]
    ranges, lo = [], 0
    for s in starts[1:]:
        if s - lo >= BLEND_CHUNK or s == len(pix):
            ranges.append((lo, s))
            lo = s
    return Sorted(g, pix, ranges, ntx)


def row_blocks(height: int):
    """The image's rows in blocks of one tile row: pairs are enumerated,
    sorted and blended a block at a time."""
    return [(r, min(r + TILE, height)) for r in range(0, height, TILE)]


def _lowp(pr: Projected) -> Projected:
    return pr._replace(m2d=_bf16(pr.m2d), conic=_bf16(pr.conic),
                       opacity=_bf16(pr.opacity), depth=_bf16(pr.depth))


def _blend(pr: Projected, sp: Sorted, lo: int, hi: int, width: int,
           npix: int, aux_dtype: str):
    """The pairs [lo, hi) (whole pixels): (payload sums [npix, 11], log
    transmittance [npix], tested and included masks), differentiable with
    respect to the float fields of `pr`."""
    dev = pr.m2d.device
    g, pix = sp.g[lo:hi], sp.pix[lo:hi]
    with torch.no_grad():
        first = torch.ones_like(pix, dtype=torch.bool)
        first[1:] = pix[1:] != pix[:-1]
        seg = torch.cumsum(first.long(), 0) - 1
        starts = torch.nonzero(first).flatten()
    mx, my = pr.m2d[g, 0], pr.m2d[g, 1]
    dx = (pix % width).double() - mx
    dy = torch.div(pix, width, rounding_mode="floor").double() - my
    a, b, c = pr.conic[g, 0], pr.conic[g, 1], pr.conic[g, 2]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(pr.opacity[g] * torch.exp(power), max=ALPHA_MAX)
    log_t = torch.log1p(-alpha)
    cs = torch.cumsum(log_t, 0)
    base = (cs - log_t)[starts][seg]
    excl = cs - log_t - base
    with torch.no_grad():
        include = (cs - base) >= math.log(T_MIN)
        tested = excl >= math.log(T_MIN)
    w = torch.where(include, alpha * torch.exp(excl), torch.zeros_like(alpha))
    aux = [pr.rgb, pr.quat, pr.scale]
    if aux_dtype == "bf16":
        aux = [_bf16(v) for v in aux]
    payload = torch.cat([aux[0], pr.depth[:, None], aux[1], aux[2]], 1)
    acc = torch.zeros((npix, 11), dtype=torch.float64, device=dev).index_add(
        0, pix, w[:, None] * payload[g])
    log_tf = torch.zeros(npix, dtype=torch.float64, device=dev).index_add(
        0, pix, torch.where(include, log_t, torch.zeros_like(log_t)))
    return acc, log_tf, tested, include


def blend(pr: Projected, height: int, width: int, aux_dtype: str = "bf16",
          lowp: bool = False):
    """(payload sums [H*W, 11], log transmittance [H*W], pairs), no
    gradient; the blend runs over pixel-aligned ranges of pairs."""
    if lowp:
        pr = _lowp(pr)
    npix = height * width
    with torch.no_grad():
        acc = torch.zeros((npix, 11), dtype=torch.float64, device=pr.m2d.device)
        log_tf = torch.zeros(npix, dtype=torch.float64, device=pr.m2d.device)
        tested = included = valid = slots = 0
        for r0, r1 in row_blocks(height):
            sp = sort_pairs(pr, height, width, r0, r1)
            valid += len(sp.g)
            tiles = sp.ntx * (-(-height // TILE))
            inst = []
            for lo, hi in sp.ranges:
                a, lt, t, inc = _blend(pr, sp, lo, hi, width, npix, aux_dtype)
                acc += a
                log_tf += lt
                tested += int(t.sum())
                included += int(inc.sum())
                pix, g = sp.pix[lo:hi][t], sp.g[lo:hi][t]
                tile = ((pix // width) // TILE) * sp.ntx + (pix % width) // TILE
                inst.append(torch.unique(g * tiles + tile))
            slots += int(torch.unique(torch.cat(inst)).numel()) if inst else 0
    pairs = {"tested": tested, "included": included, "slots": slots,
             "valid": valid}
    return acc, log_tf, pairs


def blend_backward(pr: Projected, height: int, width: int, d_acc, d_log_tf,
                   aux_dtype: str = "bf16", lowp: bool = False) -> None:
    """Accumulate into the `.grad` of `pr`'s float fields (leaves that
    require grad) the blend's vector-Jacobian product with the cotangents
    of its sums, range by range of pairs."""
    npix = height * width
    for r0, r1 in row_blocks(height):
        prx = _lowp(pr) if lowp else pr
        sp = sort_pairs(prx, height, width, r0, r1)
        for lo, hi in sp.ranges:
            if lowp:
                prx = _lowp(pr)
            acc, log_tf, _, _ = _blend(prx, sp, lo, hi, width, npix, aux_dtype)
            outs = [(o, d) for o, d in ((acc, d_acc), (log_tf, d_log_tf))
                    if d is not None]
            torch.autograd.backward([o for o, _ in outs], [d for _, d in outs])


def image(acc, log_tf, height: int, width: int, bg=None, pairs=None) -> Image:
    out = acc.T.reshape(11, height, width)
    t_img = torch.exp(log_tf).reshape(1, height, width)
    rgb = out[0:3]
    if bg is not None:
        rgb = rgb + t_img * torch.as_tensor(bg, dtype=torch.float64,
                                            device=acc.device)[:, None, None]
    return Image(rgb, out[3:4], out[4:8], out[8:11], 1 - t_img, pairs)


def rasterize(pr: Projected, height: int, width: int, bg=None,
              aux_dtype: str = "bf16", lowp: bool = False) -> Image:
    """Blend the projected Gaussians into an `Image` (no gradient)."""
    acc, log_tf, pairs = blend(pr, height, width, aux_dtype, lowp)
    return image(acc, log_tf, height, width, bg, pairs)


def render(p: dict, view: View, degree: int = 3, bg=None,
           aux_dtype: str = "bf16", lowp: bool = False):
    """(Image, Projected) of the raw leaves `p` seen by `view`."""
    with torch.no_grad():
        pr = project(p, view, degree)
        return rasterize(pr, view.height, view.width, bg, aux_dtype, lowp), pr
