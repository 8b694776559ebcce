"""The plain reference's dynamic objects and normal-prior init, float64.

  * box to world: each vehicle's canonical field is moved by its frame's
    box-to-world matrix B times the learnable residual [diag(s) R(q) | t]
    (s, q, t the residual's scales, rotation and translation); the result
    A is split by column norms into "rotation" A / |A_col| and scales
    |A_col|; means map by A and B's translation, each Gaussian's rotation
    becomes that rotation times its own (back to a quaternion by the
    branchless best-conditioned candidate, unit, w >= 0), its scales are
    multiplied by the column norms;
  * the residuals' pull toward identity: |q - (1,0,0,0)| + |s - 1| + |t|,
    each norm with its square floored at 1e-24, times 1e-3 in the loss;
    their Adam: beta (0.9, 0.999), eps 1e-8, rate 5e-3;
  * the box fields' Adam: the static rates, the means' at spatial scale 1
    and times 0.5;
  * the box poses between annotated frames: SLERP of the quaternions of
    the column-normalized rotations, lerp of column norms and translation;
  * the normal-prior init: per camera, each Gaussian in front of it (view
    z > 0.2) whose centre projects inside the image samples bilinearly the
    quaternion map of the camera's world normals (the rotation whose first
    column is the normal, completed through x, or y where |n_x| >= 0.9),
    and adds its outer product; a Gaussian that took a sample gets the
    sum's principal eigenvector (w >= 0) as rotation and scales (1e-5,
    0.1, 0.1).
"""

from __future__ import annotations

import numpy as np
import torch

from . import raster

REG = 1e-3
DELTA_LR, DELTA_EPS = 5e-3, 1e-8
BOX_XYZ_MULT = 0.5
FLAT_SCALES = (1e-5, 1e-1, 1e-1)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z): of the four candidates, the one
    whose |component|^2 = (1 +- m00 +- m11 +- m22) / 4 is largest."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    sq = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    r = torch.sqrt(torch.clamp(sq, min=1e-12))
    cands = torch.stack([
        torch.stack([r[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, r[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, r[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, r[..., 3] ** 2], -1)], -2)
    cands = cands / (2 * torch.clamp(r[..., None], min=0.1))
    best = torch.argmax(sq, -1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = raster.normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def residual(delta: dict) -> torch.Tensor:
    """[4, 4] diag(s) R(q) with translation t."""
    r = raster.rotmat(raster.normalize(delta["delta_r"]))
    top = torch.cat([delta["delta_s"][:, None] * r, delta["delta_t"][:, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                          device=top.device)
    return torch.cat([top, bottom], 0)


def to_world(a: dict, b2w: torch.Tensor, delta=None) -> dict:
    """Activated canonical arrays `a` moved by `b2w` (and the residual)."""
    m = b2w if delta is None else b2w @ residual(delta)
    cols = m[:3, :3]
    s = torch.linalg.norm(cols, dim=0)
    rot = cols / torch.clamp(s[None, :], min=1e-12)
    means = a["means"] @ cols.T + m[:3, 3]
    q = rotmat_to_quat(rot[None] @ raster.rotmat(raster.normalize(a["quats"])))
    return dict(a, means=means, quats=q, scales=a["scales"] * s[None, :])


def reg_loss(delta: dict) -> torch.Tensor:
    def safe(x):
        return torch.sqrt(torch.clamp((x * x).sum(), min=1e-24))

    e = torch.zeros_like(delta["delta_r"])
    e[0] = 1.0
    return (safe(delta["delta_r"] - e) + safe(delta["delta_s"] - 1.0)
            + safe(delta["delta_t"]))


def identity_delta(dev) -> dict:
    return {"delta_r": torch.tensor([1.0, 0, 0, 0], dtype=torch.float64, device=dev),
            "delta_s": torch.ones(3, dtype=torch.float64, device=dev),
            "delta_t": torch.zeros(3, dtype=torch.float64, device=dev)}


def interpolate_pose(ma: np.ndarray, mb: np.ndarray, t: float) -> np.ndarray:
    def split(m):
        m = torch.as_tensor(m, dtype=torch.float64)
        s = torch.linalg.norm(m[:3, :3], dim=0)
        return rotmat_to_quat(m[:3, :3] / s[None, :]), s, m[:3, 3]

    qa, sa, ta = split(ma)
    qb, sb, tb = split(mb)
    d = float(qa @ qb)
    if d < 0:
        qb, d = -qb, -d
    theta = np.arccos(min(d, 1.0))
    if np.sin(theta) < 1e-6:
        w0, w1 = 1 - t, t
    else:
        w0 = np.sin((1 - t) * theta) / np.sin(theta)
        w1 = np.sin(t * theta) / np.sin(theta)
    q = raster.normalize(w0 * qa + w1 * qb)
    out = np.eye(4)
    out[:3, :3] = (raster.rotmat(q) * ((1 - t) * sa + t * sb)[None, :]).numpy()
    out[:3, 3] = ((1 - t) * ta + t * tb).numpy()
    return out


def interpolate_poses(poses: dict, frames: list, n_interp: int) -> list:
    """{instance: matrix} of each interpolated camera between `frames`."""
    out = []
    for fa, fb in zip(frames[:-1], frames[1:]):
        a, b = poses.get(fa, {}), poses.get(fb, {})
        for k in range(n_interp):
            t = k / n_interp
            cur = {i: interpolate_pose(a[i], b[i], t) for i in set(a) & set(b)}
            cur.update({i: a[i] for i in set(a) - set(b)})
            out.append(cur)
    out.append(dict(poses.get(frames[-1], {})))
    return out


def normal_rotation(n: torch.Tensor) -> torch.Tensor:
    """[P, 3] normals -> [P, 3, 3] rotations whose first column is n."""
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    ex = torch.tensor([1.0, 0, 0], dtype=n.dtype, device=n.device).expand_as(n)
    ey = torch.tensor([0.0, 1, 0], dtype=n.dtype, device=n.device).expand_as(n)
    ref = torch.where(torch.abs(n[:, :1]) < 0.9, ex, ey)
    b = torch.linalg.cross(n, ref, dim=-1)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)
    c = torch.linalg.cross(n, b, dim=-1)
    return torch.stack([n, b, c], -1)


def normal_init(p: dict, views: list, normals_world: list) -> dict:
    """The leaves `p` with the normal-prior init applied (new tensors)."""
    means = p["means"].detach()
    n = means.shape[0]
    acc = torch.zeros((n, 4, 4), dtype=torch.float64, device=means.device)
    count = torch.zeros(n, dtype=torch.float64, device=means.device)
    for v, nw in zip(views, normals_world):
        w2c = torch.as_tensor(v.w2c, dtype=torch.float64, device=means.device)
        proj = torch.as_tensor(v.proj, dtype=torch.float64, device=means.device)
        pv = means @ w2c[:3, :3].T + w2c[:3, 3]
        clip = pv @ proj[:, :3].T + proj[:, 3]
        ndc = clip[:, :2] / (clip[:, 3:4] + 1e-7)
        h, w = v.height, v.width
        px = ((ndc[:, 0] + 1) * w - 1) * 0.5
        py = ((ndc[:, 1] + 1) * h - 1) * 0.5
        mask = ((pv[:, 2] > 0.2) & (px >= 0) & (px <= w - 1) & (py >= 0)
                & (py <= h - 1)).double()
        qmap = rotmat_to_quat(normal_rotation(nw.reshape(3, -1).T)).reshape(h, w, 4)
        x0f = torch.clamp(torch.floor(px), 0, w - 1)
        y0f = torch.clamp(torch.floor(py), 0, h - 1)
        x0, y0 = x0f.long(), y0f.long()
        x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
        fx = torch.clamp(px - x0f, 0, 1)[:, None]
        fy = torch.clamp(py - y0f, 0, 1)[:, None]
        q = (qmap[y0, x0] * (1 - fx) * (1 - fy) + qmap[y0, x1] * fx * (1 - fy)
             + qmap[y1, x0] * (1 - fx) * fy + qmap[y1, x1] * fx * fy)
        q = raster.normalize(q)
        acc += q[:, :, None] * q[:, None, :] * mask[:, None, None]
        count += mask
    has = count > 0
    # the eigenvector of the largest eigenvalue (eigh sorts them ascending);
    # on the host: the card's batched solver refuses ~10^5 small matrices
    vecs = np.linalg.eigh(acc[has].cpu().numpy())[1]
    best = torch.as_tensor(vecs[:, :, -1], device=means.device)
    best = torch.where(best[:, :1] < 0, -best, best)
    out = {k: v.clone() for k, v in p.items()}
    out["quats"][has] = best
    out["log_scales"][has] = torch.log(torch.tensor(
        FLAT_SCALES, dtype=torch.float64, device=means.device))
    return out
