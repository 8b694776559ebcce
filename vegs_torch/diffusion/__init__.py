"""Latent-diffusion stack in PyTorch, the Stable-Diffusion-2.1 architecture
(port of vegs_tpu/diffusion).

  scheduler.py   -- DDPM/DDIM noise schedule (add_noise, the SDS weight)
  unet.py        -- UNet2DCondition (cross-attention, SD-2.1 config)
  vae.py         -- AutoencoderKL encoder/decoder
  lora.py        -- LoRA adapters' parameters and files
  weights.py     -- diffusers checkpoint -> these modules
  pipeline.py    -- text encoding (CLIP) and CFG noise prediction

Every module takes small test configs; real SD-2.1 weights load from a
local checkpoint directory (none ship with the repository).
"""

from .scheduler import DiffusionSchedule  # noqa: F401
from .unet import UNet2DCondition, UNetConfig  # noqa: F401
from .vae import AutoencoderKL, VAEConfig  # noqa: F401
