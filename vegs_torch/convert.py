"""Carry weights, training state, configs and cameras from the JAX
package's numpy arrays.

The arrays come as plain numpy (e.g. `np.asarray` of each field of a
vegs_tpu GaussianField, TrainState or CameraParams) and configs as plain
dicts (`dataclasses.asdict`), so this module needs nothing from the JAX
package. The PLY snapshot (`vegs_torch.scene.load_gaussian_ply`) is the
other bridge: a PLY written by the JAX package loads unchanged.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import config as config_lib, resolve_device
from .gaussians import DensifyStats, GaussianField
from .ops.projection import CameraParams
from .optim import PARAM_LEAVES

FIELD_KEYS = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
              "opacity_logit", "valid")


def field_from_numpy(arrays: dict, device=None) -> GaussianField:
    """{means, quats, log_scales, sh_dc, sh_rest, opacity_logit, valid}
    (numpy, the JAX field's shapes) -> the port's GaussianField."""
    dev = resolve_device(device)
    missing = [k for k in FIELD_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing field arrays: {missing}")
    t = {k: torch.from_numpy(np.array(arrays[k], np.float32, copy=True)).to(dev)
         for k in FIELD_KEYS[:-1]}
    valid = torch.from_numpy(np.array(arrays["valid"], bool, copy=True)).to(dev)
    return GaussianField(valid=valid, **t)


def field_to_numpy(field: GaussianField) -> dict:
    """Inverse of `field_from_numpy`."""
    return {k: getattr(field, k).detach().cpu().numpy() for k in FIELD_KEYS}


def camera_params_from_numpy(viewmatrix, projmatrix, campos, tan_fovx,
                             tan_fovy, height: int, width: int,
                             device=None) -> CameraParams:
    """The JAX CameraParams' arrays (transposed storage kept) -> the port's."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return CameraParams(viewmatrix=f32(viewmatrix), projmatrix=f32(projmatrix),
                        campos=f32(campos), tan_fovx=f32(tan_fovx),
                        tan_fovy=f32(tan_fovy), height=int(height),
                        width=int(width))


STATS_KEYS = ("max_radii2d", "xyz_gradient_accum", "denom")


def train_state_from_numpy(arrays: dict, device=None):
    """{"field": {FIELD_KEYS}, "opt": {"mu": {leaf}, "nu": {leaf}, "count"},
    "stats": {STATS_KEYS}, "step"} (numpy; the JAX TrainState's leaves, the
    moments' `valid` entries ignored) -> the port's `train.TrainState`."""
    from .train import TrainState

    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32, copy=True)).to(dev)

    opt = {m: {k: t(arrays["opt"][m][k]) for k in PARAM_LEAVES}
           for m in ("mu", "nu")}
    opt["count"] = torch.tensor(int(arrays["opt"]["count"]), dtype=torch.int32)
    return TrainState(
        field=field_from_numpy(arrays["field"], device=dev), opt=opt,
        stats=DensifyStats(**{k: t(arrays["stats"][k]) for k in STATS_KEYS}),
        step=int(arrays["step"]))


def train_state_to_numpy(state) -> dict:
    """Inverse of `train_state_from_numpy`."""
    def n(x):
        return x.detach().cpu().numpy()

    return {
        "field": field_to_numpy(state.field),
        "opt": {**{m: {k: n(state.opt[m][k]) for k in PARAM_LEAVES}
                   for m in ("mu", "nu")},
                "count": int(state.opt["count"])},
        "stats": {k: n(getattr(state.stats, k)) for k in STATS_KEYS},
        "step": int(state.step),
    }


def config_from_dict(d: dict) -> config_lib.VegsConfig:
    """A VegsConfig from `dataclasses.asdict` of the JAX package's (the
    groups and names are the same)."""
    return config_lib.VegsConfig.from_json(json.dumps(d))
