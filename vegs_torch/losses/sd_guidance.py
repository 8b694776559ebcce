"""Diffusion guidance for extrapolated views, score matching or SDS (port
of vegs_tpu/losses/sd_guidance.py).

VAE-encode the rendering into latents (the gradient flows back through the
encoder into the render), draw a timestep in [min_step, max_step(iter)]
with the max annealed linearly to 0 across the guidance window, add noise,
take a CFG noise prediction from the (LoRA-adapted) UNet without a
gradient, then

  score matching:  L = -sum(sm_lambda * (-eps_hat / sigma_t) * z)
  SDS:             L = 0.5 * ||z - stopgrad(z - w_t * scale * (eps_hat - eps))||^2 / B

Three random draws feed a call: the encoder's sample eps, the timestep t
and the noise. `SDGuidance.draw` makes them from a `torch.Generator`; a
caller can pass them instead (`draws=`), e.g. to replay another package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..diffusion.pipeline import DiffusionModels, cfg_noise_pred, encode_image
from ..utils import trace


@dataclass
class SDGuidance:
    models: DiffusionModels
    guidance_mode: str = "score-matching"
    guidance_scale: float = 7.5
    min_step: int = 0
    max_step: int = 50
    sm_lambda: float = 1e-13
    sds_grad_scale: float = 1.0
    start_iter: int = 97_500
    max_iters: int = 100_000
    reference_cfg_orientation: bool = True

    def __post_init__(self):
        # the gradient is taken with respect to the rendering only
        self.models.unet.requires_grad_(False)
        self.models.vae.requires_grad_(False)

    def max_step_at(self, iteration) -> int:
        """The linearly annealed max timestep, max_step * (1 - frac) with
        frac = (iteration - start_iter) / window, truncated, as the JAX step
        computes it under jit from its int32 counter: the division folded
        into a multiplication by the window's float32 reciprocal, 1 - frac
        fused with it (rounded once), the product in float32. (At a frac
        where the product is an integer this gives one less than exact
        arithmetic, as the jitted JAX step does: 24, not 25, halfway
        through a 28-iteration window of max_step 50.)"""
        recip = float(np.float32(1.0)
                      / np.float32(max(self.max_iters - self.start_iter, 1)))
        # exact in float64 (a float32 times a small integer), one rounding
        rest = np.float32(1.0 - float(int(iteration) - self.start_iter) * recip)
        return int(np.float32(self.max_step) * rest)

    def latent_shape(self, pred_rgb_chw: torch.Tensor) -> tuple:
        cfg = self.models.vae.config
        f = cfg.downsample_factor
        h, w = pred_rgb_chw.shape[-2:]
        return (1, cfg.latent_channels, h // f, w // f)

    def draw(self, latent_shape, iteration,
             generator: Optional[torch.Generator]) -> dict:
        """{"eps", "t", "noise"}: the encoder's sample, a timestep per row
        in [min_step, max(max_step_at(iteration), min_step)], the noise."""
        dev = self.models.text_embeddings.device
        hi = max(self.max_step_at(iteration), self.min_step)
        eps = torch.randn(latent_shape, generator=generator, device=dev)
        t = torch.randint(self.min_step, hi + 1, (latent_shape[0],),
                          generator=generator, device=dev)
        noise = torch.randn(latent_shape, generator=generator, device=dev)
        return {"eps": eps, "t": t, "noise": noise}

    def __call__(self, pred_rgb_chw: torch.Tensor, iteration,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> torch.Tensor:
        """The guidance loss of a [3, H, W] rendering in [0, 1]."""
        if draws is None:
            draws = self.draw(self.latent_shape(pred_rgb_chw), iteration,
                              generator)
        with trace.span("vae_encode"):
            latents = encode_image(self.models, pred_rgb_chw, draws["eps"])
        sched = self.models.schedule
        t, noise = draws["t"], draws["noise"]
        # the UNet's prediction is a constant
        with torch.no_grad(), trace.span("unet_cfg"):
            eps_hat = cfg_noise_pred(
                self.models, sched.add_noise(latents.detach(), noise, t), t,
                self.guidance_scale, self.reference_cfg_orientation)
        shape = (-1,) + (1,) * (latents.ndim - 1)
        if self.guidance_mode == "score-matching":
            grad_log_prior = -eps_hat / sched.sigma(t).reshape(shape)
            return -torch.sum(self.sm_lambda * grad_log_prior * latents)
        if self.guidance_mode == "sds":
            w = sched.sds_weight(t).reshape(shape)
            grad = torch.nan_to_num(self.sds_grad_scale * w * (eps_hat - noise))
            targets = (latents - grad).detach()
            return 0.5 * torch.sum((latents - targets) ** 2) / latents.shape[0]
        raise NotImplementedError(
            f"Unknown diffusion regularization method {self.guidance_mode}")


def build_guidance(cfg_sd, checkpoint_dir: Optional[str] = None,
                   lora_dir: Optional[str] = None,
                   models: Optional[DiffusionModels] = None,
                   max_iters: int = 100_000, device=None) -> SDGuidance:
    """Guidance from the config's sd group: pass `models`, or a local SD
    checkpoint directory (and optional LoRA weights) to load on `device`."""
    if models is None:
        if checkpoint_dir is None:
            raise ValueError(
                "SD guidance needs either a DiffusionModels instance or a "
                "local checkpoint directory (no hub downloads)")
        from ..diffusion import weights

        models = weights.load_sd_checkpoint(
            checkpoint_dir, prompt=cfg_sd.prompts,
            negative_prompt=cfg_sd.negative_prompts, lora_dir=lora_dir,
            device=device)
    return SDGuidance(
        models=models,
        guidance_mode=cfg_sd.guidance_mode,
        guidance_scale=cfg_sd.sd_guidance_scale,
        min_step=cfg_sd.sd_min_step,
        max_step=cfg_sd.sd_max_step,
        sm_lambda=cfg_sd.sm_lambda,
        sds_grad_scale=cfg_sd.sds_grad_scale,
        start_iter=cfg_sd.start_guiding_from_iter,
        max_iters=max_iters,
    )
