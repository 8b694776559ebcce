"""DPT-Hybrid monocular normal estimator (port of vegs_tpu/priors/dpt.py).

The omnidata normal model (`omnidata_dpt_normal_v2.ckpt`, MiDaS's
`vitb_rn50_384` DPT): a ViT-B/16 on an R50 convolutional stem, DPT's
reassemble and RefineNet fusion decoder, and a 3-channel head whose
[0, 1]-encoded output is decoded to unit normals in the module (raw model
convention: x-right, y-down, z-backward). NCHW throughout; every submodule
has the name of its Flax twin (`stem.stage0_block0.conv1`, `block3.qkv`,
`fusion2.rcu1.conv1`, ...), so `vegs_torch.convert.dpt_from_flax` maps a
JAX parameter tree one to one.

`DPTConfig.readout` is MiDaS's readout operation at the two ViT hooks:
  * "project" (the omnidata checkpoint's, and the default): each patch
    token is concatenated with the cls token, then Linear(2D -> D) and
    exact GELU (MiDaS ProjectReadout; `pretrained.act_postprocess{3,4}.0.
    project.0.*` in the checkpoint);
  * "ignore": the cls token is dropped. This is what the JAX package
    computes for every checkpoint.

Flax's defaults are kept explicitly, as the JAX module computes: GroupNorm
and LayerNorm epsilon 1e-6, the tanh-approximated GELU in the ViT MLP, and
`jax.image.resize`'s half-pixel bilinear 2x upsampling
(`F.interpolate(..., align_corners=False)`). timm and MiDaS differ on all
three (exact GELU, epsilon 1e-5 in GroupNormAct, align_corners=True);
ROADMAP Queue 3 records them as open questions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-6     # Flax's GroupNorm/LayerNorm default
READOUTS = ("ignore", "project")


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    image_size: int = 384
    patch_grid: int = 24            # image_size / 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    resnet_blocks: Tuple[int, ...] = (3, 4, 9)   # timm R50-hybrid stage depths
    resnet_width: int = 64
    features: int = 256             # decoder channels
    vit_hooks: Tuple[int, ...] = (8, 11)         # layer3 / layer4 hooks
    out_channels: int = 3           # normals
    readout: str = "project"

    def __post_init__(self):
        if self.readout not in READOUTS:
            raise ValueError(f"readout {self.readout!r} not in {READOUTS}")

    @staticmethod
    def tiny(readout: str = "project") -> "DPTConfig":
        return DPTConfig(image_size=64, patch_grid=4, embed_dim=64, depth=2,
                         num_heads=2, resnet_blocks=(1, 1, 1), resnet_width=8,
                         features=16, vit_hooks=(0, 1), readout=readout)


def _gn(ch: int) -> nn.GroupNorm:
    """timm ResNetV2's GroupNorm(32); tiny widths shrink the groups to the
    channel count, as the JAX module does."""
    return nn.GroupNorm(min(32, ch), ch, eps=NORM_EPS)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` to twice the size (half-pixel
    centres, edges clamped)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class PreActBottleneck(nn.Module):
    """timm resnetv2 PreActBottleneck: norm -> relu before each conv; the
    shortcut (when there is one) takes the pre-activated input; the
    residual stream stays un-normalized (what the DPT hooks read)."""

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * 4
        self.norm1 = _gn(in_ch)
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Conv2d(in_ch, out_ch, 1, stride, bias=False)
        else:
            self.downsample = None
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.norm2 = _gn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.norm3 = _gn(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)

    def forward(self, x):
        xp = F.relu(self.norm1(x))
        shortcut = x if self.downsample is None else self.downsample(xp)
        h = F.relu(self.norm2(self.conv1(xp)))
        h = F.relu(self.norm3(self.conv2(h)))
        return shortcut + self.conv3(h)


class ResNetStem(nn.Module):
    """R50 hybrid backbone: 7x7/2 stem + 3x3/2 max pool, three pre-act
    stages; returns the raw stage outputs [/4 (4w), /8 (8w), /16 (16w)]."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.resnet_width
        self.conv_stem = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.norm_stem = _gn(w)
        cin = w
        for si, nb in enumerate(cfg.resnet_blocks):
            width = w * (2 ** si)
            for bi in range(nb):
                stride = 2 if (bi == 0 and si > 0) else 1
                self.add_module(f"stage{si}_block{bi}",
                                PreActBottleneck(cin, width, stride))
                cin = width * 4
        self.out_channels = cin

    def forward(self, x) -> list:
        h = F.relu(self.norm_stem(self.conv_stem(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        feats = []
        for si, nb in enumerate(self.cfg.resnet_blocks):
            for bi in range(nb):
                h = getattr(self, f"stage{si}_block{bi}")(h)
            feats.append(h)
        return feats


class ViTBlock(nn.Module):
    """timm VisionTransformer block: LN -> fused-qkv attention -> residual,
    LN -> 4x MLP (tanh GELU, as Flax's `nn.gelu`) -> residual."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.attn_proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2)
                   for z in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        a = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                          / math.sqrt(hd), dim=-1)
        o = torch.matmul(a, v).transpose(1, 2).reshape(b, t, d)
        x = x + self.attn_proj(o)
        h = F.gelu(self.mlp1(self.norm2(x)), approximate="tanh")
        return x + self.mlp2(h)


class ResidualConvUnit(nn.Module):
    """MiDaS ResidualConvUnit_custom (bn=False): relu-conv-relu-conv + skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """MiDaS FeatureFusionBlock_custom: the skip through rcu1 (when the block
    takes one), rcu2, 2x upsample, 1x1 out conv."""

    def __init__(self, features: int, skip: bool):
        super().__init__()
        self.rcu1 = ResidualConvUnit(features) if skip else None
        self.rcu2 = ResidualConvUnit(features)
        self.project = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        return self.project(upsample2x(self.rcu2(x)))


class DPTNormal(nn.Module):
    """[B, 3, H, W] normalized image ((rgb - 0.5) / 0.5) -> [B, 3, H, W]
    unit normals (x-right, y-down, z-backward: the raw model convention,
    before the tool's x/y flip). H = W = cfg.image_size."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        d, f, w = cfg.embed_dim, cfg.features, cfg.resnet_width
        self.stem = ResNetStem(cfg)
        self.patch_embed = nn.Conv2d(self.stem.out_channels, d, 1)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.patch_grid ** 2 + 1, d))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", ViTBlock(d, cfg.num_heads))
        if cfg.readout == "project":
            self.post3_readout = nn.Linear(2 * d, d)
            self.post4_readout = nn.Linear(2 * d, d)
        self.post3 = nn.Conv2d(d, d, 1)
        self.post4_proj = nn.Conv2d(d, d, 1)
        self.post4_down = nn.Conv2d(d, d, 3, 2, 1)
        for li, cin in enumerate((4 * w, 8 * w, d, d), start=1):
            self.add_module(f"scratch{li}", nn.Conv2d(cin, f, 3, padding=1,
                                                      bias=False))
        for ri in range(1, 5):
            self.add_module(f"fusion{ri}", FeatureFusion(f, skip=ri < 4))
        self.head_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.head_conv2 = nn.Conv2d(f // 2, 32, 3, padding=1)
        self.head_out = nn.Conv2d(32, cfg.out_channels, 1)

    @torch.no_grad()
    def init_from_(self, generator: torch.Generator) -> None:
        """The Flax module's init of the token parameters: cls zero,
        position embedding N(0, 0.02)."""
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def readout(self, t: torch.Tensor, hook: int) -> torch.Tensor:
        """Hook tokens [B, 1 + T, D] -> patch tokens [B, T, D]."""
        if self.cfg.readout == "ignore":
            return t[:, 1:]
        cls = t[:, :1].expand(-1, t.shape[1] - 1, -1)
        lin = self.post3_readout if hook == 3 else self.post4_readout
        return F.gelu(lin(torch.cat([t[:, 1:], cls], dim=-1)))

    def forward(self, x):
        cfg = self.cfg
        f4, f8, f16 = self.stem(x)
        tokens = self.patch_embed(f16)
        b, d, gh, gw = tokens.shape
        tokens = tokens.flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens],
                           dim=1) + self.pos_embed
        # the DPT hooks read raw block outputs (timm's final norm only
        # feeds the classifier, so it has no module here)
        hooks = {}
        for i in range(cfg.depth):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in cfg.vit_hooks:
                hooks[i] = tokens

        def to_map(t, hook):
            return self.readout(t, hook).transpose(1, 2).reshape(b, d, gh, gw)

        v16 = self.post3(to_map(hooks[cfg.vit_hooks[0]], 3))
        v32 = self.post4_down(self.post4_proj(to_map(hooks[cfg.vit_hooks[1]],
                                                     4)))
        l1, l2 = self.scratch1(f4), self.scratch2(f8)
        l3, l4 = self.scratch3(v16), self.scratch4(v32)
        h = self.fusion4(l4)            # /32 -> /16
        h = self.fusion3(h, l3)         # /16 -> /8
        h = self.fusion2(h, l2)         # /8 -> /4
        h = self.fusion1(h, l1)         # /4 -> /2
        # DPTDepthModel head: conv, 2x upsample, conv, relu, 1x1 conv,
        # non-negative ReLU -> [0, 1]-encoded normals
        h = upsample2x(self.head_conv1(h))
        out = self.head_out(F.relu(self.head_conv2(h)))
        out = torch.clamp(F.relu(out), 0.0, 1.0)
        n = (out - 0.5) * 2.0
        return n / torch.sqrt(torch.sum(n * n, dim=1, keepdim=True) + 1e-12)


def init_dpt(generator: torch.Generator, cfg: DPTConfig) -> DPTNormal:
    """A randomly initialized DPTNormal on the generator's device (Flax's
    default initializers; it does not reproduce JAX's values)."""
    from ..nn_init import empty_module, flax_default_init_

    return flax_default_init_(empty_module(lambda: DPTNormal(cfg),
                                           generator.device), generator)


# ---------------------------------------------------------------------------
# Checkpoint conversion (omnidata_dpt_normal_v2.ckpt / MiDaS DPT-hybrid)
# ---------------------------------------------------------------------------

# Checkpoint tensors that exist but that the forward pass never reads:
#   * pretrained.model.norm.*: timm's final LayerNorm feeds only the
#     classifier path;
#   * scratch.refinenet4.resConfUnit1.*: refinenet4 is called with one
#     input, so its skip unit is dead weight;
#   * pretrained.model.head.* / patch_embed.backbone.norm.*: the classifier
#     head and the backbone's final norm.
DEAD_KEY_PREFIXES = (
    "pretrained.model.norm.",
    "pretrained.model.head.",
    "pretrained.model.patch_embed.backbone.norm.",
    "scratch.refinenet4.resConfUnit1.",
)
PROJECT_KEYS = tuple(f"pretrained.act_postprocess{i}.0.project.0.{leaf}"
                     for i in (3, 4) for leaf in ("weight", "bias"))


def _std_conv(w: np.ndarray) -> np.ndarray:
    """timm ResNetV2's StdConv2d standardizes its weight at every forward
    over each output filter's fan-in; done once at conversion it is the
    same for inference."""
    w = np.asarray(w, np.float32)
    mean = w.mean(axis=(1, 2, 3), keepdims=True)
    var = w.var(axis=(1, 2, 3), keepdims=True)
    return (w - mean) / np.sqrt(var + 1e-8)


def convert_omnidata_state(state: dict, cfg: DPTConfig = DPTConfig()):
    """Map the omnidata DPT-hybrid state dict (numpy or torch tensors,
    prefix-stripped to `pretrained.*` / `scratch.*`) onto the port's
    DPTNormal parameter names.

    Returns (state_dict, unmapped): float32 CPU tensors for
    `DPTNormal(cfg).load_state_dict`, and the checkpoint keys neither read
    nor in the documented dead set. With `cfg.readout == "project"` the
    readout projections are read; with "ignore" they stay unmapped."""
    read = set()
    out = {}

    def g(k):
        read.add(k)
        v = state[k]
        return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                          else v, np.float32)

    def put(name, k, std=False):
        w = g(k)
        out[name] = torch.from_numpy(np.array(_std_conv(w) if std else w))

    bb = "pretrained.model.patch_embed.backbone"
    put("stem.conv_stem.weight", f"{bb}.stem.conv.weight", std=True)
    put("stem.norm_stem.weight", f"{bb}.stem.norm.weight")
    put("stem.norm_stem.bias", f"{bb}.stem.norm.bias")
    for si, nb in enumerate(cfg.resnet_blocks):
        for bi in range(nb):
            src = f"{bb}.stages.{si}.blocks.{bi}"
            dst = f"stem.stage{si}_block{bi}"
            for ni in (1, 2, 3):
                put(f"{dst}.norm{ni}.weight", f"{src}.norm{ni}.weight")
                put(f"{dst}.norm{ni}.bias", f"{src}.norm{ni}.bias")
                put(f"{dst}.conv{ni}.weight", f"{src}.conv{ni}.weight",
                    std=True)
            if f"{src}.downsample.conv.weight" in state:
                put(f"{dst}.downsample.weight",
                    f"{src}.downsample.conv.weight", std=True)

    put("patch_embed.weight", "pretrained.model.patch_embed.proj.weight")
    put("patch_embed.bias", "pretrained.model.patch_embed.proj.bias")
    put("cls_token", "pretrained.model.cls_token")
    put("pos_embed", "pretrained.model.pos_embed")
    names = (("norm1", "norm1"), ("qkv", "attn.qkv"),
             ("attn_proj", "attn.proj"), ("norm2", "norm2"),
             ("mlp1", "mlp.fc1"), ("mlp2", "mlp.fc2"))
    for i in range(cfg.depth):
        for dst, src in names:
            for leaf in ("weight", "bias"):
                put(f"block{i}.{dst}.{leaf}",
                    f"pretrained.model.blocks.{i}.{src}.{leaf}")

    # act_postprocess1/2 are parameterless for the hybrid backbone; 3/4
    # hold the readout at Sequential index 0 and the reassemble convs at 3
    # (and 4, the /32 downsample)
    post = [("post3", "act_postprocess3.3"), ("post4_proj", "act_postprocess4.3"),
            ("post4_down", "act_postprocess4.4")]
    if cfg.readout == "project":
        post += [("post3_readout", "act_postprocess3.0.project.0"),
                 ("post4_readout", "act_postprocess4.0.project.0")]
    for dst, src in post:
        for leaf in ("weight", "bias"):
            put(f"{dst}.{leaf}", f"pretrained.{src}.{leaf}")

    for li in range(1, 5):
        put(f"scratch{li}.weight", f"scratch.layer{li}_rn.weight")
    for ri in range(1, 5):
        src = f"scratch.refinenet{ri}"
        units = (("rcu2", "resConfUnit2"),) if ri == 4 else (
            ("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2"))
        for du, su in units:
            for ci in (1, 2):
                for leaf in ("weight", "bias"):
                    put(f"fusion{ri}.{du}.conv{ci}.{leaf}",
                        f"{src}.{su}.conv{ci}.{leaf}")
        for leaf in ("weight", "bias"):
            put(f"fusion{ri}.project.{leaf}", f"{src}.out_conv.{leaf}")
    for dst, idx in (("head_conv1", 0), ("head_conv2", 2), ("head_out", 4)):
        for leaf in ("weight", "bias"):
            put(f"{dst}.{leaf}", f"scratch.output_conv.{idx}.{leaf}")

    unmapped = sorted(
        k for k in state
        if k not in read and not k.startswith(DEAD_KEY_PREFIXES))
    return out, unmapped


def checkpoint_readout(state: dict) -> str:
    """The readout a checkpoint was trained with: "project" when it holds
    the readout projections, else "ignore"."""
    have = [k in state for k in PROJECT_KEYS]
    if any(have) and not all(have):
        raise ValueError("the checkpoint holds only some of "
                         f"{list(PROJECT_KEYS)}")
    return "project" if all(have) else "ignore"


def load_omnidata_checkpoint(path: str, cfg: DPTConfig = DPTConfig()):
    """Load `omnidata_dpt_normal_v2.ckpt` (its `state_dict` carries a
    `model.` prefix) and convert it. Returns (state_dict, unmapped).
    Raises when the checkpoint's readout is not `cfg.readout`."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in state:
        state = {k.replace("model.", "", 1): v
                 for k, v in state["state_dict"].items()}
    found = checkpoint_readout(state)
    if found != cfg.readout:
        raise ValueError(f"{path} has the {found!r} readout, the config "
                         f"{cfg.readout!r}")
    return convert_omnidata_state(state, cfg)


def dpt_from_state(state_dict: dict, cfg: DPTConfig, device=None) -> DPTNormal:
    """A DPTNormal on `device` (default: the card) holding `state_dict`
    (every parameter, with its shape)."""
    from .. import resolve_device
    from ..nn_init import empty_module

    model = empty_module(lambda: DPTNormal(cfg), resolve_device(device))
    model.load_state_dict(state_dict, strict=True)
    return model.eval()
