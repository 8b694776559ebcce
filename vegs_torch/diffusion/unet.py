"""Conditional UNet, Stable-Diffusion-2.x architecture (port of
vegs_tpu/diffusion/unet.py).

ResNet blocks with time embeddings, Transformer2D blocks with self- and
cross-attention against CLIP text states (linear projections, GEGLU
feed-forward: the SD-2.x layout), down- and upsampling, and optional LoRA
adapters on every attention projection. NCHW throughout. Every submodule
has the name of its Flax twin (`down_{i}_res{j}`, `mid_attn`,
`up_{i}_upsample`, `block.attn1.to_q.lora_down`, ...), so a Flax path maps
one to one onto a parameter name (`vegs_torch.convert`).

Flax defaults kept: norms with epsilon 1e-6, the GEGLU gate's tanh GELU,
attention as an explicit softmax(q k^T / sqrt(d)) v with `torch.matmul`.

`UNetConfig.sd21()` is stabilityai/stable-diffusion-2-1-base (~866M
parameters); `UNetConfig.tiny()` a shape-compatible miniature for tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn_init import empty_module, flax_default_init_

NORM_EPS = 1e-6  # Flax's GroupNorm/LayerNorm default


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_groups: int = 32
    with_attention: Tuple[bool, ...] = (True, True, True, False)
    lora_rank: int = 0          # 0 = no LoRA parameters
    lora_scale: float = 1.0

    @staticmethod
    def sd21() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny(cross_attention_dim: int = 32, lora_rank: int = 0) -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(32, 64),
            layers_per_block=1,
            attention_head_dim=(2, 4),
            cross_attention_dim=cross_attention_dim,
            norm_groups=8,
            with_attention=(True, True),
            lora_rank=lora_rank,
        )


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [B, dim], cos before sin
    (flip_sin_to_cos=True)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=NORM_EPS)


class LoRALinear(nn.Module):
    """Linear layer with an optional low-rank adapter:
    y = base(x) + scale * lora_up(lora_down(x))."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 scale: float = 1.0, bias: bool = True):
        super().__init__()
        self.rank, self.scale = rank, scale
        self.base = nn.Linear(in_features, features, bias=bias)
        if rank > 0:
            self.lora_down = nn.Linear(in_features, rank, bias=False)
            self.lora_up = nn.Linear(rank, features, bias=False)

    @torch.no_grad()
    def init_from_(self, generator: torch.Generator) -> None:
        """The adapters' init: lora_down normal with std 1 / rank, lora_up
        zero, so a fresh adapter adds nothing."""
        if self.rank > 0:
            self.lora_down.weight.normal_(0.0, 1.0 / self.rank,
                                          generator=generator)
            self.lora_up.weight.zero_()

    def forward(self, x):
        y = self.base(x)
        if self.rank > 0:
            y = y + self.scale * self.lora_up(self.lora_down(x))
        return y


class Attention(nn.Module):
    """Multi-head attention with an optional cross-attention context and
    LoRA on every projection."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 head_dim: int, lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim

        def mk(d_in, bias=False):
            return LoRALinear(d_in, inner, lora_rank, lora_scale, bias=bias)

        self.to_q = mk(query_dim)
        self.to_k = mk(context_dim)
        self.to_v = mk(context_dim)
        self.to_out = mk(inner, bias=True)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        h, d = self.heads, self.head_dim
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        k = self.to_k(context).reshape(b, m, h, d).transpose(1, 2)
        v = self.to_v(context).reshape(b, m, h, d).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.proj = nn.Linear(in_features, features * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class TransformerBlock(nn.Module):
    def __init__(self, heads: int, head_dim: int, cross_dim: int,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        inner = heads * head_dim
        self.norm1 = nn.LayerNorm(inner, eps=NORM_EPS)
        self.attn1 = Attention(inner, inner, heads, head_dim, lora_rank,
                               lora_scale)
        self.norm2 = nn.LayerNorm(inner, eps=NORM_EPS)
        self.attn2 = Attention(inner, cross_dim, heads, head_dim, lora_rank,
                               lora_scale)
        self.norm3 = nn.LayerNorm(inner, eps=NORM_EPS)
        self.ff_geglu = GEGLU(inner, inner * 4)
        self.ff_out = nn.Linear(inner * 4, inner)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class Transformer2D(nn.Module):
    """Spatial transformer with linear in/out projections (SD-2.x)."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 cross_dim: int, norm_groups: int, lora_rank: int = 0,
                 lora_scale: float = 1.0):
        super().__init__()
        inner = heads * head_dim
        self.norm = group_norm(norm_groups, channels)
        self.proj_in = nn.Linear(channels, inner)
        self.block = TransformerBlock(heads, head_dim, cross_dim, lora_rank,
                                      lora_scale)
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_out(self.block(self.proj_in(x), context))
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 norm_groups: int):
        super().__init__()
        self.norm1 = group_norm(norm_groups, in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = group_norm(norm_groups, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class UNet2DCondition(nn.Module):
    """sample [B, C_in, H, W], timesteps [B], context [B, L, D] ->
    noise prediction [B, C_out, H, W]."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        n = len(cfg.block_out_channels)

        def attn(i, ch):
            heads = cfg.attention_head_dim[i]
            return Transformer2D(ch, heads, ch // heads,
                                 cfg.cross_attention_dim, cfg.norm_groups,
                                 cfg.lora_rank, cfg.lora_scale)

        self.time_dense1 = nn.Linear(ch0, temb)
        self.time_dense2 = nn.Linear(temb, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        skips, prev = [ch0], ch0
        for i, ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res{j}", ResnetBlock(
                    prev, ch, temb, cfg.norm_groups))
                prev = ch
                if cfg.with_attention[i]:
                    self.add_module(f"down_{i}_attn{j}", attn(i, ch))
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        mid = cfg.block_out_channels[-1]
        mid_i = n - 1 if cfg.with_attention[-1] else max(
            i for i, a in enumerate(cfg.with_attention) if a)
        self.mid_res0 = ResnetBlock(mid, mid, temb, cfg.norm_groups)
        heads = cfg.attention_head_dim[mid_i]
        self.mid_attn = Transformer2D(mid, heads, mid // heads,
                                      cfg.cross_attention_dim,
                                      cfg.norm_groups, cfg.lora_rank,
                                      cfg.lora_scale)
        self.mid_res1 = ResnetBlock(mid, mid, temb, cfg.norm_groups)
        prev = mid
        for i in reversed(range(n)):
            ch = cfg.block_out_channels[i]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res{j}", ResnetBlock(
                    prev + skips.pop(), ch, temb, cfg.norm_groups))
                prev = ch
                if cfg.with_attention[i]:
                    self.add_module(f"up_{i}_attn{j}", attn(i, ch))
            if i > 0:
                self.add_module(f"up_{i}_upsample",
                                nn.Conv2d(ch, ch, 3, padding=1))
        self.norm_out = group_norm(cfg.norm_groups, ch0)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states):
        cfg = self.config
        ctx = encoder_hidden_states
        n = len(cfg.block_out_channels)
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_dense2(F.silu(self.time_dense1(temb)))
        h = self.conv_in(sample)
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res{j}")(h, temb)
                if cfg.with_attention[i]:
                    h = getattr(self, f"down_{i}_attn{j}")(h, ctx)
                skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_res1(self.mid_attn(self.mid_res0(h, temb), ctx), temb)
        for i in reversed(range(n)):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res{j}")(h, temb)
                if cfg.with_attention[i]:
                    h = getattr(self, f"up_{i}_attn{j}")(h, ctx)
            if i > 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


def init_unet(generator: torch.Generator, cfg: UNetConfig) -> UNet2DCondition:
    """A UNet on the generator's device with Flax's default init drawn
    from `generator`; the LoRA up-projections start at zero."""
    unet = empty_module(lambda: UNet2DCondition(cfg), generator.device)
    return flax_default_init_(unet, generator)

