"""Dynamic-object box transforms: learnable SE(3)+scale residuals (port of
vegs_tpu/boxmodel.py).

The per-(frame, instance) box-to-world transform comes from the dataset's
annotations; a learnable residual (delta_r quaternion, delta_s scale,
delta_t translation) right-multiplies it:

    adjust_box2world = box2world @ [diag(delta_s) @ R(delta_r) | delta_t]

and an L2 pull toward identity regularizes the deltas each step. Their
Adam is the fields' `vegs_torch.optim.adam_step`, in place, with eps 1e-8.
"""

from __future__ import annotations

import dataclasses

import torch

from . import geometry, resolve_device


@dataclasses.dataclass
class BoxDeltas:
    """Learnable residual of one instance in one frame."""

    delta_r: torch.Tensor  # [4] quaternion (w,x,y,z), init (1,0,0,0)
    delta_s: torch.Tensor  # [3] scales, init 1
    delta_t: torch.Tensor  # [3] translation, init 0

    LEAVES = ("delta_r", "delta_s", "delta_t")

    @staticmethod
    def identity(device=None) -> "BoxDeltas":
        dev = resolve_device(device)
        return BoxDeltas(  # built on the device: no copy from the host
            delta_r=torch.cat([torch.ones(1, device=dev),
                               torch.zeros(3, device=dev)]),
            delta_s=torch.ones(3, device=dev),
            delta_t=torch.zeros(3, device=dev),
        )

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.LEAVES}


def d_box2world(deltas: BoxDeltas) -> torch.Tensor:
    """[4, 4] residual transform: diag(s) @ R(q) with translation t."""
    R = geometry.quat_to_rotmat(deltas.delta_r)
    SR = deltas.delta_s[..., :, None] * R  # row-scaling = diag(s) @ R
    top = torch.cat([SR, deltas.delta_t[..., :, None]], dim=-1)
    # the constant row [0, 0, 0, 1] built on the device: no copy from the
    # host, so no sync, in every box of every step
    lead = top.shape[:-2]
    bottom = torch.cat([top.new_zeros(lead + (1, 3)),
                        top.new_ones(lead + (1, 1))], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def adjust_box2world(box2world: torch.Tensor, deltas: BoxDeltas) -> torch.Tensor:
    """box2world @ d_box2world(deltas)."""
    return box2world @ d_box2world(deltas)


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite (zero) gradient at ||x|| == 0.

    `torch.linalg.norm`'s gradient at exactly zero is NaN (0/0). The deltas
    START at exact identity, so a combined photometric + regularizer loss
    hits that point on the very first step, and the NaN guard of the step
    (`nan_to_num` of the delta gradients) then zeroes the WHOLE delta
    gradient, freezing the deltas at identity forever. (The reference
    never evaluates its regularizer at identity: it steps the box optimizer
    on the photometric gradient first and only then runs a separate
    regularizer backward; one combined step reproduces that through a
    subgradient instead.)"""
    ss = torch.sum(x * x, dim=dim)
    return torch.sqrt(torch.clamp(ss, min=eps * eps))


def _identity_r(deltas: BoxDeltas) -> torch.Tensor:
    """(1, 0, 0, 0) in delta_r's shape, built on its device (a scalar set
    into a 0-d slice of a card's tensor is copied from the host, a sync)."""
    r = deltas.delta_r
    return torch.cat([torch.ones_like(r[..., :1]), torch.zeros_like(r[..., 1:])],
                     dim=-1)


def regularize_loss(deltas: BoxDeltas) -> torch.Tensor:
    """L2 pull of the residual toward identity: the safe norms of
    delta_r - (1,0,0,0), delta_s - 1 and delta_t, summed."""
    return (safe_norm(deltas.delta_r - _identity_r(deltas))
            + safe_norm(deltas.delta_s - 1.0) + safe_norm(deltas.delta_t))


def delta_magnitudes(deltas: BoxDeltas):
    """(|dr|, |ds|, |dt|) for logging."""
    e = _identity_r(deltas)
    return (torch.linalg.norm(deltas.delta_r - e, dim=-1),
            torch.linalg.norm(deltas.delta_s - 1.0, dim=-1),
            torch.linalg.norm(deltas.delta_t, dim=-1))
