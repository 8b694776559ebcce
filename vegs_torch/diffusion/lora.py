"""LoRA utilities: which parameters are adapters, and their files (port of
vegs_tpu/diffusion/lora.py:23-75).

Rank-4 adapters sit on every UNet attention projection (q, k, v and out in
self- and cross-attention), under `.../to_{q,k,v,out}/lora_{down,up}`
(`unet.LoRALinear`). The file format is the JAX package's: a pickle of a
flat dict keyed by the Flax path ("params/down_0_attn0/block/attn1/to_q/
lora_down/kernel"), each value a numpy Dense kernel stored [in, out]. So a
file either package writes loads into the other.
"""

from __future__ import annotations

import os
import pickle
import re

import numpy as np
import torch
from torch import nn

LORA_KEYS = ("lora_down", "lora_up")


def _parts(path) -> list:
    if isinstance(path, str):
        return re.split(r"[./]", path)
    return [getattr(k, "key", str(k)) for k in path]


def is_lora_path(path) -> bool:
    """A parameter name ("a.b.lora_up.weight"), a Flax path string
    ("a/b/lora_up/kernel") or a sequence of path keys."""
    return any(k in LORA_KEYS for k in _parts(path))


def lora_mask(module: nn.Module) -> dict:
    """{parameter name: True on LoRA leaves} (the trainable set)."""
    return {name: is_lora_path(name) for name, _ in module.named_parameters()}


def flax_lora_key(name: str) -> str:
    """"a.b.lora_down.weight" -> "params/a/b/lora_down/kernel"."""
    parts = name.split(".")
    return "/".join(["params", *parts[:-1], "kernel"])


def split_lora(module: nn.Module) -> dict:
    """{Flax path: numpy kernel [in, out]} of the LoRA leaves."""
    return {flax_lora_key(name): p.detach().cpu().numpy().T.copy()
            for name, p in module.named_parameters() if is_lora_path(name)}


def save_lora_weights(module: nn.Module, path) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(split_lora(module), f)


@torch.no_grad()
def load_lora_weights(module: nn.Module, path_or_dir) -> nn.Module:
    """Overwrite the LoRA leaves in place from a saved file (or a directory
    holding lora_weights.pkl); leaves the file lacks keep their values.
    Returns the module."""
    path = str(path_or_dir)
    if os.path.isdir(path):
        path = os.path.join(path, "lora_weights.pkl")
    with open(path, "rb") as f:
        flat = pickle.load(f)
    for name, p in module.named_parameters():
        key = flax_lora_key(name)
        if is_lora_path(name) and key in flat:
            w = torch.from_numpy(np.asarray(flat[key], np.float32).T.copy())
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{key}: file shape {tuple(w.shape)[::-1]} "
                                 f"does not fit {tuple(p.shape)[::-1]}")
            p.copy_(w)
    return module
