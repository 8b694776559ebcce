"""Carry weights, training state, configs and cameras from the JAX
package's numpy arrays.

The arrays come as plain numpy (e.g. `np.asarray` of each field of a
vegs_tpu GaussianField, TrainState or CameraParams; CPU tensors do too) and
configs as plain dicts (`dataclasses.asdict`), so this module needs nothing
from the JAX package. `checkpoint_from_numpy` takes a whole Trainer
checkpoint tree, the JAX package's or the port's. The PLY snapshot (`vegs_torch.scene.load_gaussian_ply`) is the
other bridge: a PLY written by the JAX package loads unchanged. The
learned modules (the diffusion UNet and VAE, VGG16's features) come from
the JAX package's Flax parameter trees, as numpy (`unet_from_flax`,
`vae_from_flax`, `vgg_from_flax`, `diffusion_models_from_flax`; the DPT
normal model's as a state dict, `dpt_from_flax`).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from . import config as config_lib, resolve_device
from .boxmodel import BoxDeltas
from .gaussians import DensifyStats, GaussianField
from .ops.projection import CameraParams
from .optim import PARAM_LEAVES, AdamState

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


def shard_state_numpy(arrays: dict, index: int, n: int) -> dict:
    """Row block `index` of `n` of a (field, Adam, stats) numpy tree in
    `train_state_from_numpy`'s layout (the JAX TrainState's leaves): every
    per-Gaussian leaf cut on its first axis, the Adam count and the step
    kept whole. The rows must split evenly (pad the capacity)."""
    def rows(a):
        a = np.asarray(a)
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not split over {n}")
        m = a.shape[0] // n
        return a[index * m:(index + 1) * m].copy()

    out = {"field": {k: rows(v) for k, v in arrays["field"].items()},
           "opt": {m: {k: rows(v) for k, v in arrays["opt"][m].items()}
                   for m in ("mu", "nu")},
           "stats": {k: rows(v) for k, v in arrays["stats"].items()}}
    out["opt"]["count"] = arrays["opt"]["count"]
    if "step" in arrays:
        out["step"] = arrays["step"]
    return out


def unshard_state_numpy(blocks: list) -> dict:
    """Inverse of `shard_state_numpy`: the ranks' blocks, in rank order,
    put back together (the count and step from block 0)."""
    def cat(get):
        return np.concatenate([np.asarray(get(b)) for b in blocks])

    b0 = blocks[0]
    out = {"field": {k: cat(lambda b: b["field"][k]) for k in b0["field"]},
           "opt": {m: {k: cat(lambda b: b["opt"][m][k])
                       for k in b0["opt"][m]} for m in ("mu", "nu")},
           "stats": {k: cat(lambda b: b["stats"][k]) for k in b0["stats"]}}
    out["opt"]["count"] = b0["opt"]["count"]
    if "step" in b0:
        out["step"] = b0["step"]
    return out


def box_deltas_from_numpy(arrays: dict, device=None) -> BoxDeltas:
    """{delta_r, delta_s, delta_t} (numpy) -> BoxDeltas."""
    dev = resolve_device(device)
    return BoxDeltas(**{k: torch.from_numpy(
        np.array(arrays[k], np.float32, copy=True)).to(dev)
        for k in BoxDeltas.LEAVES})


def box_deltas_to_numpy(deltas: BoxDeltas) -> dict:
    """Inverse of `box_deltas_from_numpy`."""
    return {k: v.detach().cpu().numpy() for k, v in deltas.as_dict().items()}


def tensor_adam_from_numpy(arrays: dict, device=None) -> AdamState:
    """{"mu": {name: array}, "nu": {name: array}, "count"} (the leaves of
    the JAX package's box-residual Adam state) -> the port's Adam state of
    those leaves (`optim.AdamState`, count on the CPU)."""
    dev = resolve_device(device)

    def t(d):
        return {k: torch.from_numpy(np.array(v, np.float32, copy=True)).to(dev)
                for k, v in d.items()}

    return AdamState(mu=t(arrays["mu"]), nu=t(arrays["nu"]),
                     count=torch.tensor(int(arrays["count"]),
                                        dtype=torch.int32))


def tensor_adam_to_numpy(state: AdamState) -> dict:
    """Inverse of `tensor_adam_from_numpy`."""
    def n(d):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}

    return {"mu": n(state["mu"]), "nu": n(state["nu"]),
            "count": int(state["count"])}


BOX_STATE_KEYS = ("box_fields", "box_opts", "box_stats", "frame_deltas",
                  "frame_delta_opts")


def box_state_from_numpy(arrays: dict, device=None) -> dict:
    """A Trainer's box state from the JAX Trainer's, exported as numpy:
    {"box_fields": {inst: {FIELD_KEYS}}, "box_opts": {inst: {"mu": {leaf},
    "nu": {leaf}, "count"}}, "box_stats": {inst: {STATS_KEYS}},
    "frame_deltas": {(frame, inst): {delta_r, delta_s, delta_t}},
    "frame_delta_opts": {(frame, inst): tensor Adam arrays}} -> the same
    keys, which are the port Trainer's attribute names, with port objects.

    Each box field keeps its rows at the array's capacity, the valid ones
    first, each part in order (with their moments and statistics; a field
    whose valid rows lead is taken as it is). (While its boxes are pooled,
    the JAX Trainer pads every box to the largest box's capacity; the
    padding rows are invalid, so they render nothing.)"""
    dev = resolve_device(device)

    def rows(valid):
        # a stable partition: the valid rows, then the others, each in order
        # (the identity when the valid rows already lead)
        v = np.asarray(valid, bool)
        idx = np.concatenate([np.nonzero(v)[0], np.nonzero(~v)[0]])

        def take(x):
            return np.asarray(x)[idx]

        return take

    out = {k: {} for k in BOX_STATE_KEYS}
    for inst, f in arrays["box_fields"].items():
        take = rows(f["valid"])
        out["box_fields"][inst] = field_from_numpy(
            {k: take(f[k]) for k in FIELD_KEYS}, device=dev)
        o = arrays["box_opts"][inst]
        out["box_opts"][inst] = {
            **{m: {k: torch.from_numpy(take(o[m][k]).astype(np.float32)
                                       ).to(dev) for k in PARAM_LEAVES}
               for m in ("mu", "nu")},
            "count": torch.tensor(int(o["count"]), dtype=torch.int32)}
        out["box_stats"][inst] = DensifyStats(**{
            k: torch.from_numpy(take(arrays["box_stats"][inst][k]
                                     ).astype(np.float32)).to(dev)
            for k in STATS_KEYS})
    for key, d in arrays["frame_deltas"].items():
        out["frame_deltas"][key] = box_deltas_from_numpy(d, device=dev)
        out["frame_delta_opts"][key] = tensor_adam_from_numpy(
            arrays["frame_delta_opts"][key], device=dev)
    return out


def box_state_to_numpy(trainer) -> dict:
    """A port Trainer's box state in the layout of `box_state_from_numpy`."""
    def n(x):
        return x.detach().cpu().numpy()

    return {
        "box_fields": {i: field_to_numpy(f)
                       for i, f in trainer.box_fields.items()},
        "box_opts": {i: {**{m: {k: n(o[m][k]) for k in PARAM_LEAVES}
                            for m in ("mu", "nu")}, "count": int(o["count"])}
                     for i, o in trainer.box_opts.items()},
        "box_stats": {i: {k: n(getattr(st, k)) for k in STATS_KEYS}
                      for i, st in trainer.box_stats.items()},
        "frame_deltas": {k: box_deltas_to_numpy(d)
                         for k, d in trainer.frame_deltas.items()},
        "frame_delta_opts": {k: tensor_adam_to_numpy(o)
                             for k, o in trainer.frame_delta_opts.items()},
    }


def _as_dict(x) -> dict:
    """A record's leaves by name: a dict as it is, a dataclass's fields
    (the JAX package's records), a NamedTuple's."""
    if isinstance(x, dict):
        return x
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if hasattr(x, "_asdict"):
        return x._asdict()
    raise TypeError(f"not a record: {type(x).__name__}")


def _adam_dict(o) -> dict:
    o = _as_dict(o)
    return {"mu": _as_dict(o["mu"]), "nu": _as_dict(o["nu"]),
            "count": o["count"]}


def checkpoint_from_numpy(tree: dict, device=None) -> dict:
    """A Trainer checkpoint tree -> {"state": the port's TrainState, and
    `box_state_from_numpy`'s keys}, which `train.Trainer.restore` takes.

    The tree is the JAX Trainer's `_checkpoint_tree()` (numpy leaves, its
    records as they are, or as dicts after an orbax restore) or the port's
    own (CPU tensors, as `Trainer.save_checkpoint` writes it): "state"
    {field, opt {mu, nu, count}, stats, step}; "boxes" {str(instance):
    {field, opt, stats}}; "deltas" {"<frame>_<instance>": {deltas, opt}}.
    The moments' `valid` entries are not read."""
    st = _as_dict(tree["state"])
    state = train_state_from_numpy(
        {"field": _as_dict(st["field"]), "opt": _adam_dict(st["opt"]),
         "stats": _as_dict(st["stats"]), "step": st["step"]}, device=device)
    boxes = {k: {} for k in BOX_STATE_KEYS}
    for key, b in (tree.get("boxes") or {}).items():
        b = _as_dict(b)
        inst = int(key)
        boxes["box_fields"][inst] = _as_dict(b["field"])
        boxes["box_opts"][inst] = _adam_dict(b["opt"])
        boxes["box_stats"][inst] = _as_dict(b["stats"])
    for key, d in (tree.get("deltas") or {}).items():
        d = _as_dict(d)
        frame, inst = key.rsplit("_", 1)
        k = (int(frame), int(inst))
        boxes["frame_deltas"][k] = _as_dict(d["deltas"])
        boxes["frame_delta_opts"][k] = _adam_dict(d["opt"])
    return {"state": state, **box_state_from_numpy(boxes, device=device)}


def config_from_dict(d: dict) -> config_lib.VegsConfig:
    """A VegsConfig from `dataclasses.asdict` of the JAX package's (the
    groups and names are the same)."""
    return config_lib.VegsConfig.from_json(json.dumps(d))


# -- learned modules: Flax parameter trees <-> torch modules -----------------
#
# A Flax tree ({"params": {...}}, numpy leaves) of the JAX package's UNet,
# VAE or VGG16 maps leaf for leaf onto the port module whose submodules
# carry the Flax names: path a/b/kernel -> parameter a.b.weight (a
# convolution's HWIO kernel -> OIHW, a Dense [in, out] kernel -> [out,
# in]), a/b/scale -> a.b.weight (norms), a/b/bias -> a.b.bias.


def _flax_leaves(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flax_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return a


@torch.no_grad()
def module_from_flax_(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load a Flax parameter tree (with or without its top "params") into
    `module` in place. Every parameter must be given, with its shape."""
    params = params.get("params", params)
    named = dict(module.named_parameters())
    seen = set()
    for path, v in _flax_leaves(params).items():
        leaf = path[-1]
        name = ".".join(path[:-1] + ("bias" if leaf == "bias" else "weight",))
        if name not in named:
            raise KeyError(f"{'/'.join(path)}: the module has no {name}")
        a = _to_torch_layout(leaf, np.asarray(v, np.float32))
        p = named[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: {a.shape} for {name} "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, copy=True)))
        seen.add(name)
    missing = sorted(set(named) - seen)
    if missing:
        raise KeyError(f"the tree lacks {missing[:8]}")
    return module


def module_to_flax(module: torch.nn.Module) -> dict:
    """Inverse of `module_from_flax_`: {"params": nested numpy dict}."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *owner, leaf = name.split(".")
        sub = module.get_submodule(".".join(owner))
        a = p.detach().cpu().numpy()
        if leaf == "weight" and isinstance(sub, (torch.nn.GroupNorm,
                                                 torch.nn.LayerNorm)):
            leaf = "scale"
        elif leaf == "weight":
            leaf, a = "kernel", (a.transpose(2, 3, 1, 0) if a.ndim == 4
                                 else a.T)
        node = tree
        for k in owner:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def _built(factory, device):
    from .nn_init import empty_module

    return empty_module(factory, resolve_device(device))


def _dataclass_from(cls, d):
    d = _as_dict(d)
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


def unet_from_flax(params: dict, config, device=None):
    """A JAX UNet2DCondition's parameters (with or without LoRA leaves;
    `config` its UNetConfig or `dataclasses.asdict` of it) -> the port's."""
    from .diffusion.unet import UNet2DCondition, UNetConfig

    cfg = _dataclass_from(UNetConfig, config)
    return module_from_flax_(_built(lambda: UNet2DCondition(cfg), device),
                             params)


def vae_from_flax(params: dict, config, device=None):
    """A JAX AutoencoderKL's parameters -> the port's."""
    from .diffusion.vae import AutoencoderKL, VAEConfig

    cfg = _dataclass_from(VAEConfig, config)
    return module_from_flax_(_built(lambda: AutoencoderKL(cfg), device),
                             params)


def vgg_from_flax(params: dict, device=None):
    """The JAX VGG16Features' parameters -> the port's."""
    from .losses.vgg import VGG16Features

    return module_from_flax_(_built(VGG16Features, device), params)


def diffusion_models_from_flax(unet_params: dict, unet_config, vae_params: dict,
                               vae_config, betas, alphas_cumprod,
                               text_embeddings, device=None):
    """A JAX DiffusionModels, its parts as numpy (the two parameter trees,
    the two configs, the schedule's arrays, the text embeddings) -> the
    port's `DiffusionModels`."""
    from .diffusion.pipeline import DiffusionModels
    from .diffusion.scheduler import DiffusionSchedule

    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32, copy=True)).to(dev)

    return DiffusionModels(
        unet=unet_from_flax(unet_params, unet_config, dev),
        vae=vae_from_flax(vae_params, vae_config, dev),
        schedule=DiffusionSchedule(betas=f32(betas),
                                   alphas_cumprod=f32(alphas_cumprod),
                                   num_train_timesteps=len(betas)),
        text_embeddings=f32(text_embeddings))


def dpt_from_flax(params: dict) -> dict:
    """The JAX DPTNormal's parameter tree (numpy leaves, with or without its
    top "params") -> the port's `DPTNormal` state dict (float32 CPU
    tensors; load it with `priors.dpt.dpt_from_state`). The token
    parameters keep their names; a JAX tree has no readout projections,
    so it fits `DPTConfig(readout="ignore")`."""
    params = params.get("params", params)
    out = {}
    for path, v in _flax_leaves(params).items():
        leaf = path[-1]
        a = _to_torch_layout(leaf, np.asarray(v, np.float32))
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(
            np.array(a, copy=True))
    return out
