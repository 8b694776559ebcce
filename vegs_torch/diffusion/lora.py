"""LoRA utilities: which parameters are adapters, their files, and the
per-segment fine-tuning (port of vegs_tpu/diffusion/lora.py).

Rank-4 adapters sit on every UNet attention projection (q, k, v and out in
self- and cross-attention), under `.../to_{q,k,v,out}/lora_{down,up}`
(`unet.LoRALinear`). The file format is the JAX package's: a pickle of a
flat dict keyed by the Flax path ("params/down_0_attn0/block/attn1/to_q/
lora_down/kernel"), each value a numpy Dense kernel stored [in, out]. So a
file either package writes loads into the other.

`train_lora` fine-tunes the adapters with the epsilon-prediction MSE on
random crops of a segment's images while the base weights stay frozen,
with the JAX trainer's AdamW (optax's defaults: b1 0.9, b2 0.999, eps
1e-8, weight decay 1e-4) and cosine-decayed learning rate. Unlike the JAX
loop, which applies one update per micro-batch, each step accumulates the
mean gradient of `grad_accum` micro-batches and applies one update, and the
schedule decays over `steps` updates (the reference's bs 1 x grad-accum 4;
ROADMAP Queue 3).
"""

from __future__ import annotations

import math
import os
import pickle
import re
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .pipeline import DiffusionModels

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


# ---------------------------------------------------------------------------
# Per-segment LoRA fine-tuning
# ---------------------------------------------------------------------------


class MicroBatchDraws(NamedTuple):
    """One micro-batch's random draws: the crops' image index and top-left
    corner [n], the timesteps [n], the latents' noise and the VAE sample's
    eps [n, 4, h, w]."""
    bi: torch.Tensor
    ys: torch.Tensor
    xs: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor
    eps: torch.Tensor


def crop_at(images: torch.Tensor, bi, ys, xs, crop: int) -> torch.Tensor:
    """[B, 3, H, W] -> [n, 3, crop, crop]: image bi[i] at (ys[i], xs[i])."""
    return torch.stack([images[int(b), :, int(y):int(y) + crop,
                               int(x):int(x) + crop]
                        for b, y, x in zip(bi, ys, xs)])


def random_square_crops(generator: torch.Generator, images: torch.Tensor,
                        crop: int, n: int) -> torch.Tensor:
    """[B, 3, H, W] -> [n, 3, crop, crop] random square crops (corners drawn
    as the JAX function draws them: below max(H - crop, 1) and
    max(W - crop, 1))."""
    return crop_at(images, *_crop_corners(generator, images.shape, crop, n),
                   crop)


def _crop_corners(generator, shape, crop, n):
    b, _, h, w = shape
    dev = generator.device
    return (torch.randint(0, b, (n,), generator=generator, device=dev),
            torch.randint(0, max(h - crop, 1), (n,), generator=generator,
                          device=dev),
            torch.randint(0, max(w - crop, 1), (n,), generator=generator,
                          device=dev))


def draw_micro_batch(generator: torch.Generator, shape, crop: int, n: int,
                     latent_shape, num_train_timesteps: int) -> MicroBatchDraws:
    """The port's own draws for one micro-batch, from `generator`."""
    bi, ys, xs = _crop_corners(generator, shape, crop, n)
    dev = generator.device
    t = torch.randint(0, num_train_timesteps, (n,), generator=generator,
                      device=dev)
    noise = torch.randn(latent_shape, generator=generator, device=dev)
    eps = torch.randn(latent_shape, generator=generator, device=dev)
    return MicroBatchDraws(bi, ys, xs, t, noise, eps)


def cosine_lr(lr: float, k: int, total: int) -> float:
    """optax's `cosine_decay_schedule(lr, total)` at update k (from 0)."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(k, total) / total))


def micro_batch_loss(models: DiffusionModels, images: torch.Tensor, crop: int,
                     d: MicroBatchDraws) -> torch.Tensor:
    """The epsilon-prediction MSE of the UNet on one micro-batch's crops,
    encoded by the frozen VAE and noised at the drawn timesteps."""
    crops = crop_at(images, d.bi, d.ys, d.xs, crop)
    with torch.no_grad():
        lat = models.vae.encode(crops * 2.0 - 1.0, d.eps)
    noisy = models.schedule.add_noise(lat, d.noise, d.t)
    ctx = models.text_embeddings[0:1].expand(crops.shape[0], -1, -1)
    eps = models.unet(noisy, d.t, ctx)
    return torch.mean((eps - d.noise) ** 2)


def train_lora(
    models: DiffusionModels,
    images_chw,                   # [B, 3, H, W] scene images in [0, 1]
    *,
    steps: int = 300,
    batch_size: int = 1,
    grad_accum: int = 4,
    lr: float = 1e-4,
    crop: int = 512,
    seed: int = 0,
    draws: Optional[list] = None,
    on_step=None,
):
    """Fine-tune the LoRA leaves of `models.unet` in place.

    Each step draws `grad_accum` micro-batches of `batch_size` crops (or
    takes the next ones of `draws`, a list of `MicroBatchDraws`), adds up
    the mean of their gradients, and applies one AdamW update at the
    cosine-decayed rate of its update count. `on_step(i, loss)` is called
    after each update. Returns (models.unet, the mean loss of each step)."""
    unet, vae = models.unet, models.vae
    dev = next(unet.parameters()).device
    images = torch.as_tensor(np.asarray(images_chw), dtype=torch.float32,
                             device=dev)
    crop = min(crop, images.shape[2], images.shape[3])
    named = dict(unet.named_parameters())
    lora = [p for n, p in named.items() if is_lora_path(n)]
    if not lora:
        raise ValueError("the UNet has no LoRA parameters (lora_rank 0)")
    flags = {n: p.requires_grad for n, p in named.items()}
    for n, p in named.items():
        p.requires_grad_(is_lora_path(n))
    vae_flags = [p.requires_grad for p in vae.parameters()]
    for p in vae.parameters():
        p.requires_grad_(False)
    # optax.adamw's defaults, as the JAX trainer uses them
    opt = torch.optim.AdamW(lora, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    g = torch.Generator(device=dev).manual_seed(seed)
    f = vae.config.downsample_factor
    latent_shape = (batch_size, vae.config.latent_channels, crop // f,
                    crop // f)
    draws = iter(draws) if draws is not None else None
    losses = []
    try:
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            acc = 0.0
            for _ in range(grad_accum):
                d = next(draws) if draws is not None else draw_micro_batch(
                    g, images.shape, crop, batch_size, latent_shape,
                    models.schedule.num_train_timesteps)
                loss = micro_batch_loss(models, images, crop,
                                        MicroBatchDraws(*(x.to(dev) for x in d)))
                (loss / grad_accum).backward()
                acc += float(loss.detach())
            for group in opt.param_groups:
                group["lr"] = cosine_lr(lr, i, steps)
            opt.step()
            losses.append(acc / grad_accum)
            if on_step is not None:
                on_step(i, losses[-1])
    finally:
        for n, p in named.items():
            p.requires_grad_(flags[n])
            p.grad = None
        for p, fl in zip(vae.parameters(), vae_flags):
            p.requires_grad_(fl)
    return unet, losses
