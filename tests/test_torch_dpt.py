"""The port's DPT normal estimator (`vegs_torch.priors.dpt`) against
vegs_tpu's.

Both nets get the same weights: a synthesized omnidata checkpoint in the
real key layout (`tests/test_weight_converters.synthesize_omnidata_dpt_state`)
through each package's converter, or the JAX tree carried across with
`convert.dpt_from_flax`. Inputs are seeded numpy, NHWC for JAX and NCHW for
the port. The port's `readout="ignore"` is what JAX computes; its
`"project"` readout (the omnidata checkpoint's) has no JAX counterpart and
is held against a plain spec of MiDaS's ProjectReadout written here.

Tolerance (float32 convolutions, matmuls and norms summed in another
order): each submodule's outputs within 2e-5 of the tensor's largest |ref|
+ 1e-4 |ref| (the activations reach ~30 on these weights, and sums that
cancel keep the absolute error of their terms: 6.5e-5 read on the stem);
the whole net's unit normals within twice that bound on the head's output,
once their error is scaled by the length of the decoded vector they
normalize (`close_normals`: the division amplifies the float32 difference
where that length is under 1); the
converters' tensors equal to the bit (a rename, a transpose and the same
float32 weight standardization); `unmapped` equal as lists.
"""

import math

import jax
import numpy as np
import pytest
import torch

from tests.test_weight_converters import synthesize_omnidata_dpt_state
from vegs_torch import convert
from vegs_torch.priors import dpt as tdpt
from vegs_tpu.priors import dpt as jdpt

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def lively_state(seed):
    """`synthesize_omnidata_dpt_state` of the tiny config, rescaled so the
    net's output varies across the image: each weight of rank >= 2 to a
    variance of 1 / fan-in (as LeCun's init), each norm scale to 1 + its
    value (at 0.02 throughout, the head's output is one constant)."""
    state = synthesize_omnidata_dpt_state(jdpt.DPTConfig.tiny(),
                                          np.random.default_rng(seed))
    for k, v in state.items():
        if v.ndim >= 2 and not k.endswith(("cls_token", "pos_embed")):
            state[k] = v * np.float32(1.0 / (0.02 * np.sqrt(v[0].size)))
        elif "norm" in k and k.endswith("weight"):
            state[k] = v + np.float32(1.0)
    return state


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state dict, synthesized checkpoint) of the tiny
    config with the ignore readout."""
    state = lively_state(3)
    jparams, junmapped = jdpt.convert_omnidata_state(state,
                                                     jdpt.DPTConfig.tiny())
    tstate, tunmapped = tdpt.convert_omnidata_state(
        state, tdpt.DPTConfig.tiny(readout="ignore"))
    assert junmapped == tunmapped == []
    return jparams, tstate, state


def jax_normals(jparams, x):
    """JAX's normals, the length of the decoded vector they normalize,
    (clip(out) - 0.5) * 2, and the largest |out| of the head's last conv."""
    n, inter = jdpt.DPTNormal(jdpt.DPTConfig.tiny()).apply(
        jparams, x, capture_intermediates=True, mutable=["intermediates"])
    out = np.asarray(inter["intermediates"]["head_out"]["__call__"][0])
    length = np.linalg.norm((np.clip(out, 0, 1) - 0.5) * 2, axis=-1,
                            keepdims=True)
    return np.asarray(n), length, float(np.abs(out).max())


def close_normals(got, want, length, head_max):
    """Unit normals: the decoded vector carries twice the head's error
    (within ATOL of its largest |out|, as `close`), and the normalization
    divides it by the vector's length: |d| * min(1, length) <= 2 * ATOL *
    max(1, head_max) + RTOL * |ref|."""
    err = np.abs(got - want) * np.minimum(1.0, length)
    bound = 2 * ATOL * max(1.0, head_max) + RTOL * np.abs(want)
    assert (err <= bound).all(), float((err - bound).max())


def close(got, want, atol=ATOL, rtol=RTOL):
    """|d| <= atol * max|ref| + rtol * |ref|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def loaded(module, flax_tree):
    module.load_state_dict(convert.dpt_from_flax(flax_tree), strict=True)
    return module.eval()


def test_converters_agree_tensor_for_tensor(weights):
    jparams, tstate, _ = weights
    via_flax = convert.dpt_from_flax(jax.tree.map(np.asarray, jparams))
    assert set(via_flax) == set(tstate)
    for k, v in tstate.items():
        assert torch.equal(via_flax[k], v), k
    net = tdpt.DPTNormal(tdpt.DPTConfig.tiny(readout="ignore"))
    assert set(net.state_dict()) == set(tstate)


@pytest.mark.parametrize("si, stride", [(0, 1), (1, 2)])
def test_preact_bottleneck(weights, si, stride):
    jparams = weights[0]["params"]
    cfg = jdpt.DPTConfig.tiny()
    width = cfg.resnet_width * 2 ** si
    in_ch = cfg.resnet_width * (1 if si == 0 else 2 ** (si - 1) * 4)
    x = np.random.default_rng(si).normal(size=(2, 16, 16, in_ch)).astype(
        np.float32)
    sub = jparams["stem"][f"stage{si}_block0"]
    want = jdpt.PreActBottleneck(width, stride).apply({"params": sub}, x)
    port = loaded(tdpt.PreActBottleneck(in_ch, width, stride), sub)
    close(to_nhwc(port(nchw(x))), want)


def test_resnet_stem(weights):
    sub = weights[0]["params"]["stem"]
    x = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32)
    want = jdpt.ResNetStem(jdpt.DPTConfig.tiny()).apply({"params": sub}, x)
    port = loaded(tdpt.ResNetStem(tdpt.DPTConfig.tiny()), sub)
    got = port(nchw(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(to_nhwc(g), w)


def test_vit_block(weights):
    sub = weights[0]["params"]["block1"]
    x = np.random.default_rng(6).normal(size=(2, 17, 64)).astype(np.float32)
    want = jdpt.ViTBlock(64, 2).apply({"params": sub}, x)
    got = loaded(tdpt.ViTBlock(64, 2), sub)(torch.from_numpy(x))
    close(got.detach(), want)


def test_residual_conv_unit_and_fusion(weights):
    jparams = weights[0]["params"]
    rng = np.random.default_rng(7)
    x, skip = (rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
               for _ in range(2))
    sub = jparams["fusion2"]["rcu1"]
    want = jdpt.ResidualConvUnit(16).apply({"params": sub}, x)
    close(to_nhwc(loaded(tdpt.ResidualConvUnit(16), sub)(nchw(x))), want)
    for name, with_skip in (("fusion2", True), ("fusion4", False)):
        sub = jparams[name]
        want = jdpt.FeatureFusion(16).apply(
            {"params": sub}, x, skip if with_skip else None)
        port = loaded(tdpt.FeatureFusion(16, skip=with_skip), sub)
        got = port(nchw(x), nchw(skip) if with_skip else None)
        assert got.shape == (1, 16, 16, 16)
        close(to_nhwc(got), want)


def test_upsample_matches_jax_resize():
    x = np.random.default_rng(8).normal(size=(1, 5, 7, 2)).astype(np.float32)
    want = jax.image.resize(x, (1, 10, 14, 2), "bilinear")
    # within two float32 steps of |ref| (the weights are summed in another
    # order)
    close(to_nhwc(tdpt.upsample2x(nchw(x))), want, atol=1e-7, rtol=2.4e-7)


def test_whole_net_ignore_readout(weights):
    jparams, tstate, _ = weights
    cfg = tdpt.DPTConfig.tiny(readout="ignore")
    x = np.random.default_rng(9).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, length, head_max = jax_normals(jparams, x)
    net = tdpt.dpt_from_state(tstate, cfg, device="cpu")
    with torch.inference_mode():
        got = to_nhwc(net(nchw(x)))
    assert got.shape == (2, 64, 64, 3)
    assert want[..., 0].std() > 0.05      # the normals vary over the image
    close_normals(got, want, length, head_max)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_whole_net_from_jax_init():
    """JAX's own init (not a checkpoint) carried across by dpt_from_flax."""
    cfg = jdpt.DPTConfig.tiny()
    jparams = jax.tree.map(np.asarray, jdpt.init_dpt(jax.random.key(1), cfg))
    x = np.random.default_rng(10).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    want, length, head_max = jax_normals(jparams, x)
    net = tdpt.dpt_from_state(convert.dpt_from_flax(jparams),
                              tdpt.DPTConfig.tiny(readout="ignore"),
                              device="cpu")
    with torch.inference_mode():
        close_normals(to_nhwc(net(nchw(x))), want, length, head_max)


def test_unmapped_matches_jax_on_unknown_keys():
    state = lively_state(4)
    state["scratch.layer5_rn.weight"] = np.zeros((1, 1, 3, 3), np.float32)
    _, junmapped = jdpt.convert_omnidata_state(state, jdpt.DPTConfig.tiny())
    _, tunmapped = tdpt.convert_omnidata_state(
        state, tdpt.DPTConfig.tiny(readout="ignore"))
    assert tunmapped == junmapped == ["scratch.layer5_rn.weight"]


def with_project_keys(state, cfg, seed=11):
    rng = np.random.default_rng(seed)
    e = cfg.embed_dim
    state = dict(state)
    for i in (3, 4):
        state[f"pretrained.act_postprocess{i}.0.project.0.weight"] = (
            rng.normal(size=(e, 2 * e)) * 0.05).astype(np.float32)
        state[f"pretrained.act_postprocess{i}.0.project.0.bias"] = (
            rng.normal(size=e) * 0.05).astype(np.float32)
    return state


def test_project_keys_mapped_by_the_port_listed_by_jax(weights):
    state = with_project_keys(weights[2], jdpt.DPTConfig.tiny())
    _, junmapped = jdpt.convert_omnidata_state(state, jdpt.DPTConfig.tiny())
    assert junmapped == sorted(tdpt.PROJECT_KEYS)
    tstate, tunmapped = tdpt.convert_omnidata_state(state,
                                                    tdpt.DPTConfig.tiny())
    assert tunmapped == []
    for i in (3, 4):
        np.testing.assert_array_equal(
            tstate[f"post{i}_readout.weight"].numpy(),
            state[f"pretrained.act_postprocess{i}.0.project.0.weight"])
    # with the ignore readout the port leaves them unmapped, as JAX does
    _, ign = tdpt.convert_omnidata_state(state,
                                         tdpt.DPTConfig.tiny(readout="ignore"))
    assert ign == junmapped


def project_readout_spec(tokens, w, b):
    """MiDaS ProjectReadout: cat(patch tokens, cls token broadcast) ->
    Linear(2D -> D) -> exact GELU, in float64 numpy."""
    t = np.asarray(tokens, np.float64)
    cls = np.repeat(t[:, :1], t.shape[1] - 1, axis=1)
    z = np.concatenate([t[:, 1:], cls], -1) @ np.asarray(w, np.float64).T + b
    erf = np.vectorize(math.erf)
    return 0.5 * z * (1.0 + erf(z / math.sqrt(2.0)))


def test_project_readout_matches_the_spec(weights):
    cfg = tdpt.DPTConfig.tiny()
    state = with_project_keys(weights[2], jdpt.DPTConfig.tiny())
    tstate, _ = tdpt.convert_omnidata_state(state, cfg)
    net = tdpt.dpt_from_state(tstate, cfg, device="cpu")
    tokens = np.random.default_rng(12).normal(size=(2, 17, 64)).astype(
        np.float32)
    for hook in (3, 4):
        got = net.readout(torch.from_numpy(tokens), hook).detach().numpy()
        want = project_readout_spec(
            tokens, state[f"pretrained.act_postprocess{hook}.0.project.0.weight"],
            state[f"pretrained.act_postprocess{hook}.0.project.0.bias"])
        close(got, want, atol=1e-6, rtol=1e-5)
    # the whole net with it: unit normals, and not the ignore readout's
    x = np.random.default_rng(13).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    ign = tdpt.dpt_from_state(weights[1], tdpt.DPTConfig.tiny(readout="ignore"),
                              device="cpu")
    with torch.inference_mode():
        n_proj, n_ign = net(nchw(x)), ign(nchw(x))
    np.testing.assert_allclose(n_proj.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert float((n_proj - n_ign).abs().max()) > 1e-3


def test_load_checkpoint_checks_the_readout(weights, tmp_path):
    base = weights[2]
    for name, state in (("plain", base),
                        ("project", with_project_keys(base,
                                                      jdpt.DPTConfig.tiny()))):
        torch.save({"state_dict": {f"model.{k}": torch.from_numpy(v)
                                   for k, v in state.items()}},
                   tmp_path / f"{name}.ckpt")
    sd, unmapped = tdpt.load_omnidata_checkpoint(
        str(tmp_path / "project.ckpt"), tdpt.DPTConfig.tiny())
    assert unmapped == [] and "post4_readout.bias" in sd
    sd, unmapped = tdpt.load_omnidata_checkpoint(
        str(tmp_path / "plain.ckpt"), tdpt.DPTConfig.tiny(readout="ignore"))
    assert unmapped == [] and torch.equal(sd["block0.qkv.weight"],
                                          weights[1]["block0.qkv.weight"])
    with pytest.raises(ValueError, match="readout"):
        tdpt.load_omnidata_checkpoint(str(tmp_path / "plain.ckpt"),
                                      tdpt.DPTConfig.tiny())
    with pytest.raises(ValueError, match="readout"):
        tdpt.load_omnidata_checkpoint(str(tmp_path / "project.ckpt"),
                                      tdpt.DPTConfig.tiny(readout="ignore"))


def test_published_config_and_seeded_init():
    cfg = tdpt.DPTConfig()
    assert (cfg.readout, cfg.embed_dim, cfg.resnet_blocks, cfg.image_size,
            cfg.features) == ("project", 768, (3, 4, 9), 384, 256)
    with pytest.raises(ValueError):
        tdpt.DPTConfig(readout="add")
    g = torch.Generator().manual_seed(0)
    net = tdpt.init_dpt(g, tdpt.DPTConfig.tiny())
    assert float(net.cls_token.detach().abs().max()) == 0.0
    assert 0.01 < float(net.pos_embed.detach().std()) < 0.03
    x = torch.from_numpy(np.random.default_rng(14).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.inference_mode():
        n = net(x)
    assert n.shape == (1, 3, 64, 64) and bool(torch.isfinite(n).all())


def divergence_gaps(tstate, x):
    """The port's ignore-readout net with each suspected divergence from
    timm/MiDaS switched in alone: max and mean |d| of the unit normals
    against the net as JAX computes it. Run with -s to print them:
    python -m pytest tests/test_torch_dpt.py -k divergence -s"""
    cfg = tdpt.DPTConfig.tiny(readout="ignore")
    gelu, up = torch.nn.functional.gelu, tdpt.upsample2x

    def normals():
        net = tdpt.dpt_from_state(tstate, cfg, device="cpu")
        if eps is not None:
            for m in net.modules():
                if isinstance(m, torch.nn.GroupNorm):
                    m.eps = eps
        with torch.inference_mode():
            return net(nchw(x))

    eps = None
    base = normals()
    gaps = {}
    variants = {
        "exact GELU in the ViT MLP (timm)": ("gelu", lambda y, approximate="none":
                                             gelu(y)),
        "bilinear upsampling with align_corners=True (MiDaS Interpolate)": (
            "upsample2x", lambda y: torch.nn.functional.interpolate(
                y, scale_factor=2, mode="bilinear", align_corners=True)),
        "GroupNorm epsilon 1e-5 (timm GroupNormAct)": (None, None),
    }
    for name, (attr, fn) in variants.items():
        eps = 1e-5 if attr is None else None
        try:
            if attr == "gelu":
                torch.nn.functional.gelu = fn
            elif attr == "upsample2x":
                tdpt.upsample2x = fn
            d = (normals() - base).abs()
        finally:
            torch.nn.functional.gelu, tdpt.upsample2x = gelu, up
        gaps[name] = (float(d.max()), float(d.mean()))
    return gaps


def test_suspected_divergences_are_kept_as_jax_computes(weights):
    """The three suspected divergences from timm/MiDaS (ROADMAP Queue 3)
    each change the output; the port keeps what JAX computes (the parity
    tests above), and this prints the gap each would make."""
    x = np.random.default_rng(9).normal(size=(2, 64, 64, 3)).astype(np.float32)
    gaps = divergence_gaps(weights[1], x)
    for name, (mx, mean) in gaps.items():
        print(f"{name}: max {mx:.3e}, mean {mean:.3e}")
        assert mx > 1e-6, name
    assert tdpt.NORM_EPS == 1e-6
