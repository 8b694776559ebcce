"""Seeded initialization of `torch.nn` modules with Flax's defaults.

The learned modules of the port (the diffusion UNet and VAE, VGG16's
features) are built empty on their device and filled from an explicit
`torch.Generator`, with the initializers the JAX modules use when no
weights are loaded: LeCun normal (a normal of variance 1 / fan_in,
truncated at two standard deviations) for linear and convolution weights,
zero biases, unit norm scales. A random init does not reproduce JAX's
values; weights carried across from the JAX package go through
`vegs_torch.convert`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def empty_module(factory, device) -> nn.Module:
    """`factory()` built on the meta device, then given uninitialized
    storage on `device` (no default init is run)."""
    with torch.device("meta"):
        module = factory()
    return module.to_empty(device=device)


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `module` in place from `generator`: first
    each linear, convolution and norm layer, then each module with an
    `init_from_(generator)` of its own (the LoRA adapters), which refills
    its layers."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if hasattr(m, "init_from_"):
            m.init_from_(generator)
    return module


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's `lecun_normal` (fan_in: the input features times the kernel
    window)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)
