"""VGG perceptual loss, feature L1 with an optional Gram style term (port
of vegs_tpu/losses/perceptual.py).

Four VGG16 blocks' feature L1, inputs resized to 224x224 and
ImageNet-normalized; the trainer applies it when cfg.sd.perceptual_loss is
set (the reference instantiates it but never calls it).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils import trace
from . import vgg


def _resize224(x_chw: torch.Tensor) -> torch.Tensor:
    """Bilinear to 224x224 with an antialiasing filter when downsampling,
    as `jax.image.resize(..., "bilinear")` resizes."""
    return F.interpolate(x_chw[None], size=(224, 224), mode="bilinear",
                         antialias=True, align_corners=False)[0]


def _gram(f: torch.Tensor) -> torch.Tensor:
    b, c, h, w = f.shape
    m = f.reshape(b, c, h * w)
    return torch.matmul(m, m.transpose(1, 2)) / (h * w)


def vgg_perceptual_loss(model: vgg.VGG16Features, pred_chw: torch.Tensor,
                        target_chw: torch.Tensor,
                        feature_layers: Sequence[int] = (0, 1, 2, 3),
                        style_layers: Sequence[int] = ()) -> torch.Tensor:
    """[3, H, W] renders in [0, 1]; no gradient flows into the target."""
    with trace.span("vgg_perceptual"):
        f_pred = vgg.extract_features(model, _resize224(pred_chw))
        f_tgt = vgg.extract_features(model, _resize224(target_chw).detach())
        loss = pred_chw.new_zeros(())
        for i in feature_layers:
            loss = loss + torch.mean(torch.abs(f_pred[i] - f_tgt[i]))
        for i in style_layers:
            loss = loss + torch.mean(torch.abs(_gram(f_pred[i])
                                               - _gram(f_tgt[i])))
    return loss
