"""Diffusion noise schedule (port of vegs_tpu/diffusion/scheduler.py).

The scaled-linear beta schedule Stable Diffusion trains with: the guidance
losses need alphas_cumprod, `add_noise` and the SDS weighting
w(t) = 1 - alpha_bar_t; `ddim_step` is the deterministic DDIM update.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor           # [T] float32
    alphas_cumprod: torch.Tensor  # [T] float32
    num_train_timesteps: int

    @staticmethod
    def scaled_linear(num_train_timesteps: int = 1000,
                      beta_start: float = 0.00085, beta_end: float = 0.012,
                      device=None) -> "DiffusionSchedule":
        """Built in float64 numpy and cast to float32, as the JAX schedule."""
        dev = resolve_device(device)
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
        alphas_cumprod = np.cumprod(1.0 - betas)
        return DiffusionSchedule(
            betas=torch.from_numpy(betas.astype(np.float32)).to(dev),
            alphas_cumprod=torch.from_numpy(
                alphas_cumprod.astype(np.float32)).to(dev),
            num_train_timesteps=num_train_timesteps)

    def _at(self, t) -> torch.Tensor:
        return self.alphas_cumprod[torch.as_tensor(
            t, device=self.alphas_cumprod.device)]

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """q(x_t | x_0) sample: sqrt(a_bar) x0 + sqrt(1 - a_bar) eps (t
        a scalar or one timestep per leading row of x0)."""
        a = self._at(t)
        if a.ndim:
            a = a.reshape((-1,) + (1,) * (x0.ndim - 1))
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def sigma(self, t) -> torch.Tensor:
        """Noise std sqrt(1 - a_bar_t)."""
        return torch.sqrt(1.0 - self._at(t))

    def sds_weight(self, t) -> torch.Tensor:
        """w(t) = 1 - a_bar_t (standard SDS weighting)."""
        return 1.0 - self._at(t)

    def ddim_step(self, x_t: torch.Tensor, eps: torch.Tensor, t: int,
                  t_prev: int, eta: float = 0.0) -> torch.Tensor:
        """Deterministic DDIM update x_t -> x_{t_prev} (t_prev < 0: x_0)."""
        a_t = self.alphas_cumprod[t]
        a_prev = (self.alphas_cumprod[t_prev] if t_prev >= 0
                  else torch.ones_like(a_t))
        x0_pred = (x_t - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0_pred + torch.sqrt(1 - a_prev) * eps
