"""LPIPS perceptual distance with the VGG backbone (port of
vegs_tpu/losses/lpips.py).

Channel-normalized per-block features, 1x1 linear heads, spatial mean, sum
over the blocks. The backbone loads torchvision VGG16 weights and the heads
the LPIPS 'vgg.pth' export (`load_lpips_weights`); with no weights on disk
`lpips_available()` is False and metrics omit LPIPS. The weights directory
is $VEGS_WEIGHTS_DIR, else `build/weights` in the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import vgg

# channel dims of the 5 VGG blocks used by LPIPS-vgg
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

DEFAULT_WEIGHT_DIR = os.environ.get(
    "VEGS_WEIGHTS_DIR",
    str(Path(__file__).resolve().parents[2] / "build" / "weights"))


def _normalize_activation(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (norm + eps)


def lpips(model: vgg.VGG16Features, lin_weights, x_chw: torch.Tensor,
          y_chw: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between [3, H, W] images in [0, 1]."""
    fx = vgg.extract_features(model, x_chw, normalization="lpips")
    fy = vgg.extract_features(model, y_chw, normalization="lpips")
    total = x_chw.new_zeros(())
    for a, b, w in zip(fx, fy, lin_weights):
        d = (_normalize_activation(a) - _normalize_activation(b)) ** 2
        total = total + torch.mean(torch.sum(d * w[None, :, None, None], dim=1))
    return total


def random_lin_weights(generator: torch.Generator) -> list:
    """Uniform positive heads, on the generator's device -- for tests only."""
    return [torch.rand((c,), generator=generator, device=generator.device)
            * 0.01 for c in LPIPS_CHANNELS]


def load_lpips_weights(path: str, device=None) -> list:
    """The linear heads from an .npz with arrays lin0..lin4 (each [C])."""
    dev = resolve_device(device)
    data = np.load(path)
    return [torch.from_numpy(np.ravel(data[f"lin{i}"]).astype(np.float32)
                             ).to(dev) for i in range(5)]


def lpips_available(weight_dir: Optional[str] = None) -> bool:
    d = weight_dir or DEFAULT_WEIGHT_DIR
    return (os.path.exists(os.path.join(d, "vgg16_features.npz"))
            and os.path.exists(os.path.join(d, "lpips_vgg_lins.npz")))


def load_default(weight_dir: Optional[str] = None, device=None):
    d = weight_dir or DEFAULT_WEIGHT_DIR
    model = vgg.load_npz(os.path.join(d, "vgg16_features.npz"), device)
    lins = load_lpips_weights(os.path.join(d, "lpips_vgg_lins.npz"), device)
    return model, lins
