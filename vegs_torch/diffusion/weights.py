"""A Stable-Diffusion checkpoint in the diffusers layout -> the port's
modules (port of vegs_tpu/diffusion/weights.py).

Maps the diffusers `unet/diffusion_pytorch_model.*` and
`vae/diffusion_pytorch_model.*` state dicts onto `UNet2DCondition` and
`AutoencoderKL`. Both sides are PyTorch layouts, so the map renames and
copies: no transpose. Runs offline against a local checkpoint directory
(the Hugging Face hub layout). LoRA weights saved by the LoRA trainer (the
JAX package's pickle, `lora.py`) fill the `lora_down`/`lora_up` leaves.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn


def _load_state_dict(model_dir: str) -> dict:
    """safetensors or a torch .bin from a diffusers model directory, as CPU
    tensors."""
    st_path = os.path.join(model_dir, "diffusion_pytorch_model.safetensors")
    bin_path = os.path.join(model_dir, "diffusion_pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    return torch.load(bin_path, map_location="cpu", weights_only=True)


class _Map(dict):
    """{port parameter name: diffusers key}, built with the Flax
    converter's helper names."""

    def __init__(self, state: dict):
        super().__init__()
        self.state = state

    def leaf(self, dst: str, src: str) -> None:
        if src not in self.state:
            raise KeyError(src)
        self[dst] = src

    def both(self, dst: str, src: str, bias: bool = True) -> None:
        """dst.weight <- src.weight (and the biases)."""
        self.leaf(f"{dst}.weight", f"{src}.weight")
        if bias:
            self.leaf(f"{dst}.bias", f"{src}.bias")

    def shortcut(self, dst: str, src: str) -> None:
        if f"{src}.conv_shortcut.weight" in self.state:
            self.both(f"{dst}.shortcut", f"{src}.conv_shortcut")


@torch.no_grad()
def _fill(module: nn.Module, state: dict, names: _Map) -> nn.Module:
    """Copy state[names[p]] into every mapped parameter of `module`. Every
    parameter but the LoRA adapters must be mapped, with its shape."""
    from .lora import is_lora_path

    params = dict(module.named_parameters())
    unmapped = [n for n in params if n not in names and not is_lora_path(n)]
    unknown = [n for n in names if n not in params]
    if unmapped or unknown:
        raise KeyError(f"parameters without a checkpoint tensor: "
                       f"{unmapped[:8]}; mapped names the module lacks: "
                       f"{unknown[:8]}")
    for dst, src in names.items():
        v = state[src]
        v = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
        p = params[dst]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{src}: shape {tuple(v.shape)} for {dst} "
                             f"{tuple(p.shape)}")
        p.copy_(v.to(p.dtype))
    return module


def _module(factory, cfg, device, generator):
    """The module on `device`, every parameter drawn from `generator` (a
    fresh one seeded 0 by default): the LoRA adapters keep those values."""
    from .. import resolve_device
    from ..nn_init import empty_module, flax_default_init_

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return flax_default_init_(empty_module(lambda: factory(cfg), dev),
                              generator)


def unet_names(state: dict, cfg) -> _Map:
    """The port UNet's parameter names -> diffusers UNet2DConditionModel
    keys."""
    p = _Map(state)
    p.both("time_dense1", "time_embedding.linear_1")
    p.both("time_dense2", "time_embedding.linear_2")
    p.both("conv_in", "conv_in")
    p.both("norm_out", "conv_norm_out")
    p.both("conv_out", "conv_out")

    def resnet(dst, src):
        for n in ("norm1", "conv1", "time_emb_proj", "norm2", "conv2"):
            p.both(f"{dst}.{n}", f"{src}.{n}")
        p.shortcut(dst, src)

    def transformer(dst, src):
        for n in ("norm", "proj_in", "proj_out"):
            p.both(f"{dst}.{n}", f"{src}.{n}")
        blk_src, blk = f"{src}.transformer_blocks.0", f"{dst}.block"
        for i, attn in ((1, "attn1"), (2, "attn2")):
            for proj in ("to_q", "to_k", "to_v"):
                p.both(f"{blk}.{attn}.{proj}.base", f"{blk_src}.{attn}.{proj}",
                       bias=False)
            p.both(f"{blk}.{attn}.to_out.base", f"{blk_src}.{attn}.to_out.0")
            p.both(f"{blk}.norm{i}", f"{blk_src}.norm{i}")
        p.both(f"{blk}.norm3", f"{blk_src}.norm3")
        p.both(f"{blk}.ff_geglu.proj", f"{blk_src}.ff.net.0.proj")
        p.both(f"{blk}.ff_out", f"{blk_src}.ff.net.2")

    n = len(cfg.block_out_channels)
    for i in range(n):
        for j in range(cfg.layers_per_block):
            resnet(f"down_{i}_res{j}", f"down_blocks.{i}.resnets.{j}")
            if cfg.with_attention[i]:
                transformer(f"down_{i}_attn{j}",
                            f"down_blocks.{i}.attentions.{j}")
        if i < n - 1:
            p.both(f"down_{i}_downsample", f"down_blocks.{i}.downsamplers.0.conv")
    resnet("mid_res0", "mid_block.resnets.0")
    resnet("mid_res1", "mid_block.resnets.1")
    transformer("mid_attn", "mid_block.attentions.0")
    for i in reversed(range(n)):
        ui = n - 1 - i  # diffusers' up_blocks index
        for j in range(cfg.layers_per_block + 1):
            resnet(f"up_{i}_res{j}", f"up_blocks.{ui}.resnets.{j}")
            if cfg.with_attention[i]:
                transformer(f"up_{i}_attn{j}", f"up_blocks.{ui}.attentions.{j}")
        if i > 0:
            p.both(f"up_{i}_upsample", f"up_blocks.{ui}.upsamplers.0.conv")
    return p


def vae_names(state: dict, cfg) -> _Map:
    """The port VAE's parameter names -> diffusers AutoencoderKL keys."""
    p = _Map(state)

    def vresnet(dst, src):
        for n in ("norm1", "conv1", "norm2", "conv2"):
            p.both(f"{dst}.{n}", f"{src}.{n}")
        p.shortcut(dst, src)

    def vattn(dst, src):
        p.both(f"{dst}.norm", f"{src}.group_norm")
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("proj_out", "to_out.0")):
            p.both(f"{dst}.{a}", f"{src}.{b}")

    n = len(cfg.block_out_channels)
    for half in ("encoder", "decoder"):
        for name, src in (("conv_in", "conv_in"), ("norm_out", "conv_norm_out"),
                          ("conv_out", "conv_out")):
            p.both(f"{half}.{name}", f"{half}.{src}")
        vresnet(f"{half}.mid_res0", f"{half}.mid_block.resnets.0")
        vresnet(f"{half}.mid_res1", f"{half}.mid_block.resnets.1")
        vattn(f"{half}.mid_attn", f"{half}.mid_block.attentions.0")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            vresnet(f"encoder.down_{i}_res{j}",
                    f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            p.both(f"encoder.down_{i}_downsample",
                   f"encoder.down_blocks.{i}.downsamplers.0.conv")
    for i in reversed(range(n)):
        ui = n - 1 - i
        for j in range(cfg.layers_per_block + 1):
            vresnet(f"decoder.up_{i}_res{j}",
                    f"decoder.up_blocks.{ui}.resnets.{j}")
        if i > 0:
            p.both(f"decoder.up_{i}_upsample",
                   f"decoder.up_blocks.{ui}.upsamplers.0.conv")
    p.both("quant_conv", "quant_conv")
    p.both("post_quant_conv", "post_quant_conv")
    return p


def convert_unet_state(state: dict, cfg, device=None,
                       generator: Optional[torch.Generator] = None):
    """A diffusers UNet2DConditionModel state dict (tensors or numpy) ->
    a `UNet2DCondition` on `device`; with `cfg.lora_rank` the adapters are
    fresh (drawn from `generator`)."""
    from .unet import UNet2DCondition

    unet = _module(UNet2DCondition, cfg, device, generator)
    return _fill(unet, state, unet_names(state, cfg))


def convert_vae_state(state: dict, cfg, device=None):
    """A diffusers AutoencoderKL state dict -> an `AutoencoderKL`."""
    from .vae import AutoencoderKL

    vae = _module(AutoencoderKL, cfg, device, None)
    return _fill(vae, state, vae_names(state, cfg))


def load_sd_checkpoint(checkpoint_dir: str, prompt: str,
                       negative_prompt: str = "",
                       lora_dir: Optional[str] = None, lora_rank: int = 4,
                       device=None):
    """`DiffusionModels` from a local diffusers checkpoint tree (unet/,
    vae/, tokenizer/, text_encoder/) on `device` (default: the card). With
    `lora_dir` the UNet gets rank-`lora_rank` adapters, fresh (seed 0) and
    then read from the directory's lora_weights.pkl; the sentinel "init"
    keeps the fresh ones (the per-segment LoRA trainer's start)."""
    import dataclasses

    from .lora import load_lora_weights
    from .pipeline import DiffusionModels, encode_text_embeddings
    from .scheduler import DiffusionSchedule
    from .unet import UNetConfig
    from .vae import VAEConfig

    ucfg = UNetConfig.sd21()
    if lora_dir is not None:
        ucfg = dataclasses.replace(ucfg, lora_rank=lora_rank)
    vcfg = VAEConfig.sd()
    unet = convert_unet_state(
        _load_state_dict(os.path.join(checkpoint_dir, "unet")), ucfg, device)
    if lora_dir is not None and lora_dir != "init":
        load_lora_weights(unet, lora_dir)
    vae = convert_vae_state(
        _load_state_dict(os.path.join(checkpoint_dir, "vae")), vcfg, device)
    dev = unet.conv_in.weight.device
    return DiffusionModels(
        unet=unet, vae=vae,
        schedule=DiffusionSchedule.scaled_linear(device=dev),
        text_embeddings=encode_text_embeddings(checkpoint_dir, prompt,
                                               negative_prompt, device=dev))
