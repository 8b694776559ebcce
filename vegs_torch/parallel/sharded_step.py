"""A batch of cameras over a data axis (port of the camera helpers of
vegs_tpu/parallel/sharded_step.py): `stack_camera_batch` stacks the
cameras' parameters, and rank r takes row r (`camera_at`), as device r of
the JAX mesh sees its shard.

The data-parallel step itself (the JAX package's `make_dp_train_step`,
and its full model's) is `vegs_torch.train.train_step` with a `comm`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.projection import CameraParams


def stack_camera_batch(cams: list, device=None) -> CameraParams:
    """Cameras (their CameraParams on `device`, default the card) or
    CameraParams -> one CameraParams with leaves [D, ...]."""
    params = [c if isinstance(c, CameraParams) else c.device_params(device)
              for c in cams]
    h, w = params[0].height, params[0].width
    if any(p.height != h or p.width != w for p in params):
        raise ValueError("a camera batch shares one resolution")
    return CameraParams(**{
        f.name: torch.stack([getattr(p, f.name) for p in params])
        for f in dataclasses.fields(CameraParams)
        if f.name not in ("height", "width")}, height=h, width=w)


def camera_at(batch: CameraParams, i: int) -> CameraParams:
    """Row i of a stacked camera batch."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[i]
        for f in dataclasses.fields(CameraParams)
        if f.name not in ("height", "width")})
