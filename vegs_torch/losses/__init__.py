"""Losses of the static training step (port of vegs_tpu/losses, the
photometric and normal-guidance terms)."""

from .photometric import l1_loss, l2_loss, psnr, ssim  # noqa: F401
from .normal_guidance import loss_normal_guidance  # noqa: F401
