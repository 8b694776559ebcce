"""The plain reference's training step, float64: render (`raster`), the
loss (1 - 0.2) L1 + 0.2 (1 - SSIM) + 1e-3 normal loss, autograd, the 3DGS
Adam update of the six leaves, and the densification statistics.

  * SSIM: 11x11 Gaussian window (sigma 1.5), zero padding, c1 = 0.01^2,
    c2 = 0.03^2, the variances clamped at 0, mean over the map;
  * normal loss: per pixel 0.8 mean_j |n . R_j| + 0.2 mean_j |n . (R_j
    s_j)| with R the blended rotation's matrix (held constant in the
    second term), s the blended scales, n the prior's world normal;
  * Adam: beta (0.9, 0.999), eps 1e-15, bias-corrected; learning rates
    means 1.6e-5 * extent decaying log-linearly to 1.6e-6 * extent over
    30,000 steps of the trainer's own step count, SH DC 2.5e-3, SH rest
    1.25e-4, opacity 0.05, scales 1e-3, rotations 1e-3;
  * densification statistics: per view, the norm of the 2D means'
    gradient scaled by (W/2, H/2) is added where the Gaussian is visible,
    and the visible count by one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import boxes, raster

LEAVES = ("means", "quats", "log_scales", "sh_dc", "sh_rest", "opacity_logit")
LAMBDA_DSSIM = 0.2
LAMBDA_NORMAL = 1e-3
LRS = {"quats": 1e-3, "log_scales": 1e-3, "sh_dc": 2.5e-3,
       "sh_rest": 2.5e-3 / 20, "opacity_logit": 0.05}
POS_LR = (1.6e-5, 1.6e-6, 30_000)
BETAS, EPS = (0.9, 0.999), 1e-15


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xs = torch.arange(11, dtype=torch.float64, device=a.device) - 5
    g = torch.exp(-xs * xs / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = torch.outer(g, g)[None, None].expand(3, 1, 11, 11)

    def f(x):
        return F.conv2d(x[None], win, padding=5, groups=3)[0]

    mu1, mu2 = f(a), f(b)
    s1 = torch.clamp(f(a * a) - mu1 * mu1, min=0.0)
    s2 = torch.clamp(f(b * b) - mu2 * mu2, min=0.0)
    s12 = f(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def normal_loss(quat: torch.Tensor, scale: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    r = raster.rotmat(raster.normalize(quat.reshape(4, -1).T))
    s = scale.reshape(3, -1).T
    nn = n.reshape(3, -1).T
    rot = torch.abs(torch.einsum("pi,pij->pj", nn, r)).mean(1)
    sc = torch.abs(torch.einsum("pi,pij->pj", nn, r.detach() * s[:, None, :])).mean(1)
    return (0.8 * rot + 0.2 * sc).mean()


def position_lr(step: int, extent: float) -> float:
    lr0, lr1, steps = POS_LR
    t = min(max(step / steps, 0.0), 1.0)
    return math.exp(math.log(lr0 * extent) * (1 - t) + math.log(lr1 * extent) * t)


def loss_of(img: raster.Image, gt, normal_world):
    l1 = (img.rgb - gt).abs().mean()
    return ((1 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1 - ssim(img.rgb, gt))
            + LAMBDA_NORMAL * normal_loss(img.quat, img.scale, normal_world))


class Adam:
    """Leaves (float64) and their Adam moments and step count."""

    def __init__(self, leaves: dict, eps: float = EPS):
        self.p = {k: v.detach().double().clone() for k, v in leaves.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.eps = eps

    def update(self, grads: dict, lrs: dict) -> None:
        self.count += 1
        c1 = 1 - BETAS[0] ** self.count
        c2 = 1 - BETAS[1] ** self.count
        for k, g in grads.items():
            self.m[k].mul_(BETAS[0]).add_((1 - BETAS[0]) * g)
            self.v[k].mul_(BETAS[1]).add_((1 - BETAS[1]) * g * g)
            self.p[k].sub_(lrs[k] * (self.m[k] / c1)
                           / (torch.sqrt(self.v[k] / c2) + self.eps))


class State:
    """The reference's run: the static field's Adam (its `count` is the
    trainer's step), each vehicle's field's Adam, each (frame, vehicle)
    residual's Adam, and the static field's densification statistics."""

    def __init__(self, leaves: dict, boxes: dict = None):
        self.field = Adam(leaves)
        self.boxes = {i: Adam(b) for i, b in (boxes or {}).items()}
        self.deltas = {}
        n = len(self.field.p["means"])
        dev = self.field.p["means"].device
        self.accum = torch.zeros(n, dtype=torch.float64, device=dev)
        self.denom = torch.zeros(n, dtype=torch.float64, device=dev)


def _grads(p: dict) -> dict:
    return {k: p[k].grad if p[k].grad is not None else torch.zeros_like(p[k])
            for k in p}


def step(st: State, view, gt, normal_world, extent: float,
         aux_dtype: str = "bf16", lowp: bool = False, frame: int = 0,
         box_poses: dict = None) -> tuple:
    """One training step in place -> (loss, gradients, pairs): gradients
    {leaf: tensor}, with the vehicles' as "box.<leaf>" and the residuals'
    as "delta.<leaf>" lists. `box_poses` ({vehicle: [4, 4]}) are the
    frame's vehicles, rendered after the static field in that order."""
    dev = gt.device
    p = {k: v.clone().requires_grad_(True) for k, v in st.field.p.items()}
    parts = [raster.arrays(p)]
    bp, dp = {}, {}
    for i, m in (box_poses or {}).items():
        if (frame, i) not in st.deltas:
            st.deltas[(frame, i)] = Adam(boxes.identity_delta(dev), boxes.DELTA_EPS)
        bp[i] = {k: v.clone().requires_grad_(True) for k, v in st.boxes[i].p.items()}
        dp[i] = {k: v.clone().requires_grad_(True)
                 for k, v in st.deltas[(frame, i)].p.items()}
        b2w = torch.as_tensor(m, dtype=torch.float64, device=dev)
        parts.append(boxes.to_world(raster.arrays(bp[i]), b2w, dp[i]))
    arr = {k: torch.cat([a[k] for a in parts]) for k in parts[0]}
    pr = raster.project_arrays(arr, view, 3)
    # the blend's inputs as leaves: its gradient is taken in ranges of
    # pixels from the cotangents of the whole image, then carried back
    # through the projection
    fields = ("m2d", "depth", "conic", "opacity", "rgb", "quat", "scale")
    prl = pr._replace(**{f: getattr(pr, f).detach().requires_grad_(True)
                         for f in fields})
    h, w = view.height, view.width
    acc, log_tf, pairs = raster.blend(prl, h, w, aux_dtype, lowp)
    acc.requires_grad_(True)
    log_tf.requires_grad_(True)
    img = raster.image(acc, log_tf, h, w)
    loss = loss_of(img, gt, normal_world)
    if dp:
        reg = boxes.REG * sum(boxes.reg_loss(d) for d in dp.values())
        loss = loss + reg
    loss.backward()
    raster.blend_backward(prl, h, w, acc.grad, log_tf.grad, aux_dtype, lowp)
    torch.autograd.backward(
        [getattr(pr, f) for f in fields],
        [getattr(prl, f).grad if getattr(prl, f).grad is not None
         else torch.zeros_like(getattr(pr, f)) for f in fields])
    grads = _grads(p)
    n = len(p["means"])
    with torch.no_grad():
        step_no = st.field.count
        st.field.update(grads, dict(LRS, means=position_lr(step_no, extent)))
        box_lrs = dict(LRS, means=position_lr(step_no, boxes.BOX_XYZ_MULT))
        for k in LEAVES if bp else ():
            grads["box." + k] = []
        for k in ("delta_r", "delta_s", "delta_t") if dp else ():
            grads["delta." + k] = []
        for i in bp:
            gb = _grads(bp[i])
            st.boxes[i].update(gb, box_lrs)
            gd = {k: torch.nan_to_num(g, nan=0.0) for k, g in _grads(dp[i]).items()}
            st.deltas[(frame, i)].update(gd, {k: boxes.DELTA_LR for k in gd})
            for k in gb:
                grads["box." + k].append(gb[k])
            for k in gd:
                grads["delta." + k].append(gd[k])
        vis = pr.radius[:n] > 0
        scale = torch.tensor([view.width * 0.5, view.height * 0.5],
                             dtype=torch.float64, device=dev)
        gm = prl.m2d.grad[:n] if prl.m2d.grad is not None else torch.zeros_like(pr.m2d[:n])
        st.accum += torch.where(vis, torch.linalg.norm(gm * scale, dim=1),
                                torch.zeros_like(st.accum))
        st.denom += vis.double()
    return float(loss.detach()), grads, pairs


def world_normal(n_cam: torch.Tensor, r_w2c: np.ndarray) -> torch.Tensor:
    """Camera-space normals [3, H, W] rotated to world space."""
    r = torch.as_tensor(np.asarray(r_w2c), dtype=torch.float64,
                        device=n_cam.device)
    return torch.einsum("ji,jhw->ihw", r, n_cam.double())
