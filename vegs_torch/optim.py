"""Per-leaf Adam with the 3DGS learning-rate policy (port of
vegs_tpu/optim.py).

The Adam state is a plain dict of tensors, {"mu": {leaf: tensor}, "nu":
{leaf: tensor}, "count": int32 tensor}, row-aligned with the field, as in
the JAX package: densification recompacts parameters and moments row for
row (vegs_torch.densify), which `torch.optim.Adam`'s per-parameter state
does not allow.

Learning rates (the reference's training_setup):
  means:   position_lr_init * spatial_scale, exp-decayed to position_lr_final
           * spatial_scale over position_lr_max_steps (log-lerp with delay)
  sh_dc:   feature_lr;  sh_rest: feature_lr / 20
  opacity: opacity_lr;  log_scales: scaling_lr;  quats: rotation_lr
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import OptimizationParams

PARAM_LEAVES = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                "opacity_logit")


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear interpolated LR with an optional delayed sine ramp; 0 for
    step < 0."""
    step = float(step)
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(math.log(lr_init) * (1 - t)
                                 + math.log(lr_final) * t)


class FieldLRs(NamedTuple):
    means: float
    quats: float
    log_scales: float
    sh_dc: float
    sh_rest: float
    opacity_logit: float


def field_lrs(opt: OptimizationParams, spatial_scale: float,
              step) -> FieldLRs:
    """Per-leaf learning rates at `step`."""
    xyz = expon_lr(
        step,
        opt.position_lr_init * spatial_scale,
        opt.position_lr_final * spatial_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    return FieldLRs(
        means=xyz,
        quats=opt.rotation_lr,
        log_scales=opt.scaling_lr,
        sh_dc=opt.feature_lr,
        sh_rest=opt.feature_lr / 20.0,
        opacity_logit=opt.opacity_lr,
    )


def adam_init(field) -> dict:
    """Zero moments for the six parameter leaves of `field`."""
    def zeros():
        return {k: torch.zeros_like(getattr(field, k).detach())
                for k in PARAM_LEAVES}

    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adam_step(field, grads: dict, state: dict, lrs: FieldLRs,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> None:
    """One Adam update of the six parameter leaves, IN PLACE: the field's
    parameters and the state's moments and count are updated where they lie
    (the JAX package returns new arrays; in place saves a copy of the field
    and both moments per step). eps is the reference's 1e-15."""
    count = state["count"] + 1
    # bias corrections in float32, as the JAX package computes them
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    for name, lr in zip(PARAM_LEAVES, lrs):
        p = getattr(field, name)
        g = grads[name]
        m = state["mu"][name]
        v = state["nu"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    state["count"] = count
