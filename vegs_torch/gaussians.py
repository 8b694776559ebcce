"""Gaussian field state (port of vegs_tpu/gaussians.py).

The field lives in fixed-capacity tensors with a validity mask, stored raw
(pre-activation): exp for scales, sigmoid for opacity, L2-normalize for
quaternions. SH features are split into a DC row and 15 rest rows. Beside
the field: the running densification statistics and the initialisation
from a point cloud.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import geometry, resolve_device, sh as sh_lib
from .utils import trace


class GaussianField(nn.Module):
    """Fixed-capacity Gaussian cloud parameters (all raw/pre-activation)."""

    def __init__(self, means, quats, log_scales, sh_dc, sh_rest,
                 opacity_logit, valid):
        super().__init__()
        self.means = nn.Parameter(means)                # [C, 3]
        self.quats = nn.Parameter(quats)                # [C, 4] (w,x,y,z)
        self.log_scales = nn.Parameter(log_scales)      # [C, 3]
        self.sh_dc = nn.Parameter(sh_dc)                # [C, 1, 3]
        self.sh_rest = nn.Parameter(sh_rest)            # [C, 15, 3]
        self.opacity_logit = nn.Parameter(opacity_logit)  # [C, 1]
        self.register_buffer("valid", valid)            # [C] bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def num_active(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()

    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    def opacities(self) -> torch.Tensor:
        # Dead slots get exactly 0 opacity so they never contribute.
        op = torch.sigmoid(self.opacity_logit)
        return torch.where(self.valid[:, None], op, torch.zeros_like(op))

    def rotations(self) -> torch.Tensor:
        return geometry.quat_normalize(self.quats)

    def features(self) -> torch.Tensor:
        """[C, 16, 3] concatenated SH coefficients."""
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)

    def covariance(self, scale_modifier: float = 1.0) -> torch.Tensor:
        return geometry.covariance_from_scaling_rotation(
            self.scales(), self.rotations(), scale_modifier)

    def covariance6(self, scale_modifier: float = 1.0) -> torch.Tensor:
        return geometry.strip_symmetric(self.covariance(scale_modifier))


@dataclasses.dataclass
class DensifyStats:
    """Running densification statistics, row-aligned with the field."""

    max_radii2d: torch.Tensor         # [C] max observed screen radius (px)
    xyz_gradient_accum: torch.Tensor  # [C] sum of ||grad means2D|| (NDC)
    denom: torch.Tensor               # [C] number of accumulations

    @staticmethod
    def zeros(capacity: int, device=None) -> "DensifyStats":
        dev = resolve_device(device)

        def z():
            return torch.zeros((capacity,), dtype=torch.float32, device=dev)

        return DensifyStats(max_radii2d=z(), xyz_gradient_accum=z(), denom=z())


def sh_band_mask(active_degree: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[16] mask: 1 for coefficients within the active SH degree else 0."""
    degrees = np.repeat(np.arange(4), np.arange(4) * 2 + 1)  # 0,1,1,1,2,...
    with trace.span("sh_mask.copy", sync=True):  # from pageable memory
        mask = torch.as_tensor(degrees <= active_degree, device=device)
    return mask.to(dtype)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def round_capacity(n: int, multiple: int = 4096) -> int:
    """Bucket capacities to a multiple of `multiple` (as the JAX package
    does, so layouts compare)."""
    return max(multiple, -(-n // multiple) * multiple)


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance from each point to its k nearest neighbours
    (host side, init time only; a KD-tree)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    if len(pts) <= k:
        return np.full((len(pts),), 1e-4, np.float32)
    tree = cKDTree(pts)
    dists, _ = tree.query(pts, k=k + 1, workers=-1)  # self at index 0
    return np.mean(dists[:, 1:] ** 2, axis=1).astype(np.float32)


def create_from_points(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    init_opacity: float = 0.1,
    scale_clip: tuple[float, float] = (1e-7, 0.2),
    device=None,
) -> GaussianField:
    """Seed a field from a point cloud: isotropic scale sqrt(mean squared
    distance to 3 nearest neighbours), the SQUARED distance clamped to
    `scale_clip` first (the reference's order); identity rotation; opacity
    `init_opacity`; padded to `capacity` with valid=False rows, on `device`
    (default: the card)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    cap = capacity if capacity is not None else round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    dc = sh_lib.rgb_to_sh(np.asarray(colors, np.float32)).astype(np.float32)
    d2 = np.clip(knn_mean_sq_dist(points), scale_clip[0], scale_clip[1])
    log_s = np.log(np.sqrt(d2))[:, None].repeat(3, 1).astype(np.float32)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    logit = float(np.log(init_opacity / (1.0 - init_opacity)))
    return GaussianField(
        means=pad(points),
        quats=pad(quats),
        log_scales=pad(log_s, fill=np.float32(np.log(1e-7))),
        sh_dc=pad(dc[:, None, :]),
        sh_rest=torch.zeros((cap, 15, 3), dtype=torch.float32, device=dev),
        opacity_logit=pad(np.full((n, 1), logit, np.float32)),
        valid=torch.from_numpy(valid).to(dev),
    )


def create_random(generator: torch.Generator, n: int, extent: float = 1.0,
                  capacity=None, device=None) -> GaussianField:
    """Random field for tests: points uniform in [-extent, extent]^3 and
    colors uniform in [0, 1], drawn on the CPU from `generator`."""
    pts = (torch.rand((n, 3), generator=generator) * 2 - 1) * extent
    cols = torch.rand((n, 3), generator=generator)
    return create_from_points(pts.numpy(), cols.numpy(), capacity=capacity,
                              device=device)


# ---------------------------------------------------------------------------
# PLY interop (the reference's attribute layout)
# ---------------------------------------------------------------------------


def to_ply_arrays(field: GaussianField) -> dict[str, np.ndarray]:
    """Active Gaussians as the reference's PLY attribute layout (f_rest
    flattened channel-major)."""
    valid = field.valid.detach().cpu().numpy()
    idx = np.nonzero(valid)[0]

    def take(x):
        return x.detach().cpu().numpy()[idx]

    return {
        "xyz": take(field.means),
        "normals": np.zeros((len(idx), 3), np.float32),
        "f_dc": take(field.sh_dc).transpose(0, 2, 1).reshape(len(idx), -1),
        "f_rest": take(field.sh_rest).transpose(0, 2, 1).reshape(len(idx), -1),
        "opacities": take(field.opacity_logit),
        "scale": take(field.log_scales),
        "rotation": take(field.quats),
    }


def from_ply_arrays(xyz, f_dc, f_rest, opacities, scale, rotation,
                    capacity=None, device=None) -> GaussianField:
    """Field from PLY attribute arrays, zero-padded to `capacity` (default:
    a multiple of 4096) with valid=False rows, on `device` (default: the
    card; see `resolve_device`)."""
    device = resolve_device(device)
    n = xyz.shape[0]
    cap = capacity if capacity is not None else round_capacity(n)

    def pad(x):
        x = np.asarray(x, np.float32)
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(device)

    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return GaussianField(
        means=pad(xyz),
        quats=pad(rotation),
        log_scales=pad(scale),
        sh_dc=pad(np.asarray(f_dc, np.float32).reshape(n, 3, 1).transpose(0, 2, 1)),
        sh_rest=pad(np.asarray(f_rest, np.float32).reshape(n, 3, 15).transpose(0, 2, 1)),
        opacity_logit=pad(np.asarray(opacities, np.float32).reshape(n, 1)),
        valid=torch.from_numpy(valid).to(device),
    )
