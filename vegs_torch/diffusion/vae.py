"""AutoencoderKL, the Stable Diffusion VAE (port of
vegs_tpu/diffusion/vae.py).

The guidance loss backpropagates the rendering through the ENCODER into
latent space; the decoder is there for completeness. ResNet stacks with one
mid self-attention, 8x downsampling at SD's widths, 4 latent channels,
scaling factor 0.18215. NCHW, with the Flax twin's submodule names. The
encoder's downsampling pads the bottom and right by one and convolves with
stride 2 and no padding, as `padding=((0, 1), (0, 1))` does in Flax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn_init import empty_module, flax_default_init_
from .unet import group_norm

SD_VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = SD_VAE_SCALE

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_groups=4)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class VResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm_groups: int):
        super().__init__()
        self.norm1 = group_norm(norm_groups, in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = group_norm(norm_groups, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class VAttention(nn.Module):
    """Single-head self-attention over the pixels: softmax(q k^T / sqrt(c)) v."""

    def __init__(self, channels: int, norm_groups: int):
        super().__init__()
        self.norm = group_norm(norm_groups, channels)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        flat = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.q(flat), self.k(flat), self.v(flat)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c),
                             dim=-1)
        out = self.proj_out(torch.matmul(attn, v))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        prev = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res{j}",
                                VResnet(prev, ch, cfg.norm_groups))
                prev = ch
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2, padding=0))
        ch = chs[-1]
        self.mid_res0 = VResnet(ch, ch, cfg.norm_groups)
        self.mid_attn = VAttention(ch, cfg.norm_groups)
        self.mid_res1 = VResnet(ch, ch, cfg.norm_groups)
        self.norm_out = group_norm(cfg.norm_groups, ch)
        # moments: mean and log-variance
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        cfg = self.config
        n = len(cfg.block_out_channels)
        h = self.conv_in(x)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res{j}")(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res1(self.mid_attn(self.mid_res0(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        chs = cfg.block_out_channels
        ch = chs[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_res0 = VResnet(ch, ch, cfg.norm_groups)
        self.mid_attn = VAttention(ch, cfg.norm_groups)
        self.mid_res1 = VResnet(ch, ch, cfg.norm_groups)
        prev = ch
        for i in reversed(range(len(chs))):
            ch = chs[i]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res{j}",
                                VResnet(prev, ch, cfg.norm_groups))
                prev = ch
            if i > 0:
                self.add_module(f"up_{i}_upsample",
                                nn.Conv2d(ch, ch, 3, padding=1))
        self.norm_out = group_norm(cfg.norm_groups, chs[0])
        self.conv_out = nn.Conv2d(chs[0], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        cfg = self.config
        h = self.mid_res1(self.mid_attn(self.mid_res0(self.conv_in(z))))
        for i in reversed(range(len(cfg.block_out_channels))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res{j}")(h)
            if i > 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        lat = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_moments(self, x):
        """[B, 3, H, W] in [-1, 1] -> (mean, logvar) latents [B, 4, h, w]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, eps: Optional[torch.Tensor] = None):
        """Scaled latent sample mean + exp(logvar / 2) * eps (the mode when
        `eps` is None)."""
        mean, logvar = self.encode_moments(x)
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
        return z * self.config.scaling_factor

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.config.scaling_factor))

    def forward(self, x, eps: Optional[torch.Tensor] = None):
        return self.decode(self.encode(x, eps))


def init_vae(generator: torch.Generator, cfg: VAEConfig) -> AutoencoderKL:
    """A VAE on the generator's device with Flax's default init drawn from
    `generator`."""
    vae = empty_module(lambda: AutoencoderKL(cfg), generator.device)
    return flax_default_init_(vae, generator)
