"""Photometric losses: L1/L2 (masked), windowed SSIM, PSNR (port of
vegs_tpu/losses/photometric.py: 11x11 Gaussian window, sigma 1.5).

The SSIM filters are depthwise 2D convolutions in full float32. On a card,
cuDNN would run a float32 convolution in TF32 by default, which keeps about
three decimal digits; the E[x^2] - mu^2 cancellation below then carries
noise larger than c2 = 9e-4, the denominators go negative and the SSIM
gradient explodes (the fault the JAX package fixed for bf16 convolutions,
photometric.py:57-63). So the filter and its backward run with TF32 off,
and the variances are clamped at 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    d = torch.abs(pred - gt)
    if mask is not None:
        return torch.sum(d * mask) / (torch.sum(mask) * (d.numel() / mask.numel()) + 1e-8)
    return torch.mean(d)


def l2_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    d = (pred - gt) ** 2
    if mask is not None:
        return torch.sum(d * mask) / (torch.sum(mask) * (d.numel() / mask.numel()) + 1e-8)
    return torch.mean(d)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over flattened pixels."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter_f32(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c = img.shape[0]
    rhs = window[None, None].expand(c, 1, *window.shape)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        return F.conv2d(img[None], rhs, padding=window.shape[-1] // 2,
                        groups=c)[0]


class _DepthwiseFilter(torch.autograd.Function):
    """[C, H, W] -> same, per-channel 2D filtering with zero 'SAME' padding.
    The window is symmetric, so the filter is its own adjoint: the backward
    is the same filter, also run with TF32 off (autograd's own conv
    backward would run outside the forward's flags)."""

    @staticmethod
    def forward(ctx, img, window):
        ctx.save_for_backward(window)
        return _filter_f32(img, window)

    @staticmethod
    def backward(ctx, grad):
        (window,) = ctx.saved_tensors
        return _filter_f32(grad.contiguous(), window), None


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images in [0, 1]."""
    window = torch.from_numpy(_gaussian_window(window_size, sigma)).to(img1.device)

    def filt(x):
        return _DepthwiseFilter.apply(x, window)

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # E[x^2] - mu^2 can dip below 0 in float; true variances are >= 0.
    # torch.maximum, as jnp.maximum: half the gradient where it is exactly 0
    zero = img1.new_zeros(())
    sigma1_sq = torch.maximum(filt(img1 * img1) - mu1_sq, zero)
    sigma2_sq = torch.maximum(filt(img2 * img2) - mu2_sq, zero)
    sigma12 = filt(img1 * img2) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
