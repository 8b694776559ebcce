"""VGG16 feature extractor, shared by the perceptual loss and LPIPS (port
of vegs_tpu/losses/vgg.py).

torchvision's vgg16 `features` (13 convolutions in five blocks, ReLU, 2x2
max pools), returning each block's activation after its last ReLU. Weights
load from a torchvision state dict (`load_torch_state_dict`) or its .npz
export (`load_npz`); with no weights the features are a seeded random init
(`init_params`). NCHW; the convolutions carry the Flax names
`conv{block}_{i}`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

# torchvision vgg16.features layer plan: (out_channels, n_convs) per block
VGG16_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# torchvision's conv indices within `features`
TORCHVISION_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# LPIPS variant normalization (lpipsPyTorch/modules/utils.py semantics)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """[B, 3, H, W], already normalized -> the five blocks' activations."""

    def __init__(self):
        super().__init__()
        cin = 3
        for bi, (ch, n_convs) in enumerate(VGG16_PLAN):
            for ci in range(n_convs):
                self.add_module(f"conv{bi}_{ci}",
                                nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x) -> list:
        feats = []
        for bi, (_, n_convs) in enumerate(VGG16_PLAN):
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            feats.append(x)
            if bi < len(VGG16_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


def init_params(generator: torch.Generator) -> VGG16Features:
    """Random features on the generator's device (Flax's default init)."""
    from ..nn_init import empty_module, flax_default_init_

    return flax_default_init_(empty_module(VGG16Features, generator.device),
                              generator)


@torch.no_grad()
def load_torch_state_dict(state: dict, device=None) -> VGG16Features:
    """A torchvision vgg16 `features` state dict ('features.{i}.weight' and
    '.bias', tensors or numpy) -> VGG16Features on `device` (default: the
    card)."""
    from ..nn_init import empty_module

    model = empty_module(VGG16Features, resolve_device(device))
    idx = iter(TORCHVISION_CONV_IDX)
    for bi, (_, n_convs) in enumerate(VGG16_PLAN):
        for ci in range(n_convs):
            i = next(idx)
            conv = getattr(model, f"conv{bi}_{ci}")
            for leaf in ("weight", "bias"):
                v = torch.as_tensor(np.asarray(state[f"features.{i}.{leaf}"]),
                                    dtype=torch.float32)
                getattr(conv, leaf).copy_(v)
    return model


def load_npz(path: str, device=None) -> VGG16Features:
    data = np.load(path)
    return load_torch_state_dict({k: data[k] for k in data.files}, device)


def _per_channel(values, x):
    return torch.tensor(values, dtype=x.dtype, device=x.device)[:, None, None]


def normalize_imagenet(x_rgb01: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] in [0, 1] -> ImageNet-normalized."""
    return ((x_rgb01 - _per_channel(IMAGENET_MEAN, x_rgb01))
            / _per_channel(IMAGENET_STD, x_rgb01))


def normalize_lpips(x_rgb01: torch.Tensor) -> torch.Tensor:
    """LPIPS scaling layer: the input in [-1, 1], shifted and scaled."""
    x = x_rgb01 * 2.0 - 1.0
    return (x - _per_channel(LPIPS_SHIFT, x)) / _per_channel(LPIPS_SCALE, x)


def extract_features(model: VGG16Features, x_rgb01_chw: torch.Tensor,
                     normalization: str = "imagenet") -> list:
    """[3, H, W] (or [B, 3, H, W]) in [0, 1] -> list of [B, c, h, w]."""
    x = x_rgb01_chw[None] if x_rgb01_chw.ndim == 3 else x_rgb01_chw
    x = normalize_imagenet(x) if normalization == "imagenet" else normalize_lpips(x)
    return model(x)
