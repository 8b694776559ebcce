"""StyleGAN2-style image ops in plain PyTorch (port of
vegs_tpu/ops/image_ops.py).

The reference vendors CUDA kernels for these whose only consumer is its
vestigial StyleGAN2 module; the JAX package has no Pallas kernel here, so
they port as plain tensor code: bias + leaky ReLU + gain, and
upsample -> FIR filter -> downsample (`upfirdn2d`) as one zero-insertion,
pad and strided convolution. NCHW, as the rest of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """(x + bias) -> leaky ReLU -> * scale; `bias` [C] adds along dim 1 of
    an [N, C, ...] tensor (along the only dim of a 1-D one)."""
    if bias is not None:
        x = x + (bias if x.ndim < 2
                 else bias.reshape(1, -1, *([1] * (x.ndim - 2))))
    return torch.where(x >= 0, x, x * negative_slope) * scale


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Upsample by `up` (zeros between and after the samples), pad both
    axes by (pad0, pad1) (negative crops), filter with `kernel` [kh, kw]
    (a convolution), keep every `down`-th sample. x: [B, C, H, W]."""
    b, c, h, w = x.shape
    pad0, pad1 = pad
    z = x.reshape(b * c, 1, h, w)
    if up > 1:
        zu = z.new_zeros((b * c, 1, h * up, w * up))
        zu[:, :, ::up, ::up] = z
        z = zu
    z = F.pad(z, (pad0, pad1, pad0, pad1))
    k = kernel.flip(0, 1).to(x.dtype)[None, None]
    out = F.conv2d(z, k, stride=down)
    return out.reshape(b, c, out.shape[-2], out.shape[-1])


def make_fir_kernel(k) -> torch.Tensor:
    """A 1-D spec -> its normalized separable 2-D FIR kernel (a 2-D spec is
    normalized as it is)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = torch.outer(k, k)
    return k / torch.sum(k)
