"""Text encoding and classifier-free-guided noise prediction (port of
vegs_tpu/diffusion/pipeline.py).

The pieces the guidance loss needs: CLIP text embeddings (transformers'
torch `CLIPTextModel`, from a local SD checkpoint, or any [2, L, D] tensor
for tests) and the CFG UNet evaluation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .scheduler import DiffusionSchedule
from .unet import UNet2DCondition, UNetConfig, init_unet
from .vae import AutoencoderKL, VAEConfig, init_vae


class DiffusionModels(NamedTuple):
    unet: UNet2DCondition
    vae: AutoencoderKL
    schedule: DiffusionSchedule
    text_embeddings: torch.Tensor   # [2, L, D]: (prompt, negative prompt)

    @staticmethod
    def tiny(generator: torch.Generator, image_size: int = 32,
             lora_rank: int = 0) -> "DiffusionModels":
        """A randomly initialized miniature stack for tests, on the
        generator's device. (`image_size` is kept for the JAX signature: the
        port's modules need no example input to be built.)"""
        del image_size
        dev = generator.device
        ucfg = UNetConfig.tiny(lora_rank=lora_rank)
        unet = init_unet(generator, ucfg)
        vae = init_vae(generator, VAEConfig.tiny())
        text = torch.randn((2, 8, ucfg.cross_attention_dim), generator=generator,
                           device=dev) * 0.02
        return DiffusionModels(
            unet=unet, vae=vae,
            schedule=DiffusionSchedule.scaled_linear(1000, device=dev),
            text_embeddings=text)


def encode_text_embeddings(checkpoint_dir: str, prompt: str,
                           negative_prompt: str = "",
                           device=None) -> torch.Tensor:
    """[2, L, D] CLIP text embeddings from a local SD checkpoint directory
    (tokenizer/ and text_encoder/ in the Hugging Face layout), on `device`
    (default: the card). The encoder runs once on the CPU and is freed."""
    from transformers import CLIPTextModel, CLIPTokenizer

    from .. import resolve_device

    dev = resolve_device(device)
    # local_files_only: a missing file fails here instead of being fetched
    tokenizer = CLIPTokenizer.from_pretrained(
        checkpoint_dir, subfolder="tokenizer", local_files_only=True)
    encoder = CLIPTextModel.from_pretrained(
        checkpoint_dir, subfolder="text_encoder", local_files_only=True)
    embeds = []
    with torch.no_grad():
        for p in (prompt, negative_prompt):
            tokens = tokenizer(p, padding="max_length",
                               max_length=tokenizer.model_max_length,
                               return_tensors="pt")
            embeds.append(encoder(tokens.input_ids)[0][0])
    return torch.stack(embeds).to(dev, torch.float32)


def encode_image(models: DiffusionModels, rgb_chw: torch.Tensor,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[3, H, W] in [0, 1] -> scaled latents [1, 4, h, w] (sampled with
    `eps`, the mode without)."""
    return models.vae.encode(rgb_chw[None] * 2.0 - 1.0, eps)


def cfg_noise_pred(models: DiffusionModels, latents_noisy: torch.Tensor,
                   t: torch.Tensor, guidance_scale: float,
                   reference_cfg_orientation: bool = True) -> torch.Tensor:
    """Classifier-free-guided noise prediction.

    The reference concatenates the text embeddings as (prompt, negative)
    but combines the chunks as `uncond + scale * (pos - uncond)` with the
    PROMPT prediction in the `uncond` slot, i.e. its guidance extrapolates
    toward the negative prompt. `reference_cfg_orientation=True` (the
    default, as in the JAX package) keeps that; False is the standard
    orientation.
    """
    b = latents_noisy.shape[0]
    lat2 = torch.cat([latents_noisy] * 2)
    tt = torch.cat([t] * 2)
    ctx = torch.repeat_interleave(models.text_embeddings, b, dim=0)
    eps_prompt, eps_neg = models.unet(lat2, tt, ctx).chunk(2)
    if reference_cfg_orientation:
        return eps_prompt + guidance_scale * (eps_neg - eps_prompt)
    return eps_neg + guidance_scale * (eps_prompt - eps_neg)
