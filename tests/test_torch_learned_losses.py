"""The port's VGG16 features, perceptual loss and LPIPS
(`vegs_torch.losses.{vgg,perceptual,lpips}`) against vegs_tpu's.

Weights: the port's seeded random VGG16 features as a Flax tree
(`convert.module_to_flax`; Flax's init of VGG16 is slow on the CPU), and a
synthetic torchvision `features` state dict loaded by both packages'
`load_torch_state_dict` (equal to the bit), and by `load_npz`.

Tolerances: `_resize224` within 5e-6 (the port's antialiased bilinear
against `jax.image.resize`, from 48x64 up and from 376x1408 down; the two
compute the filter weights in float32 by other formulas; measured
2.6e-6); `extract_features`, both normalizations, within 1e-4 of each
block's largest |activation|; `vgg_perceptual_loss` (with and without the
style term) and LPIPS within a relative 1e-4 (float32 convolutions summed
in another order; measured 1.5e-7); the perceptual loss's gradient with
respect to the prediction within a relative L2 error of 1e-3 (a ReLU mask,
a max-pool choice or an L1 sign of a near-zero term flips between the two
float32 runs on ~0.6% of the pixels; measured 1.0e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_weight_converters import synthesize_torchvision_vgg16_state
from vegs_torch import convert
from vegs_torch.losses import lpips as tlpips, perceptual as tperc, vgg as tvgg
from vegs_tpu.losses import lpips as jlpips, perceptual as jperc, vgg as jvgg

RESIZE_ATOL = 5e-6
FEAT_RTOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vggs():
    """(JAX params, port VGG16Features) with the same weights."""
    g = torch.Generator()
    g.manual_seed(0)
    model = tvgg.init_params(g)
    params = jax.tree.map(jnp.asarray, convert.module_to_flax(model))
    return params, convert.vgg_from_flax(convert.module_to_flax(model),
                                         device="cpu")


def image(seed, h, w):
    return np.random.default_rng(seed).uniform(size=(3, h, w)).astype(np.float32)


@pytest.mark.parametrize("hw", [(48, 64), (376, 1408)])
def test_resize224_matches_jax(hw):
    x = image(1, *hw)
    got = tperc._resize224(torch.from_numpy(x)).numpy()
    want = np.asarray(jperc._resize224(jnp.asarray(x)))
    assert got.shape == want.shape == (3, 224, 224)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_torchvision_weights_load_alike(tmp_path):
    state = synthesize_torchvision_vgg16_state(np.random.default_rng(2))
    want = jax.tree.map(np.asarray, jvgg.load_torch_state_dict(state))
    for model in (tvgg.load_torch_state_dict(state, device="cpu"),
                  tvgg.load_torch_state_dict(
                      {k: torch.from_numpy(v) for k, v in state.items()},
                      device="cpu")):
        got = convert.module_to_flax(model)["params"]
        assert sorted(got) == sorted(want["params"])
        for k, leaves in want["params"].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(got[k][leaf], v, err_msg=k)
    np.savez(tmp_path / "vgg.npz", **state)
    got = convert.module_to_flax(tvgg.load_npz(str(tmp_path / "vgg.npz"),
                                               device="cpu"))
    np.testing.assert_array_equal(
        got["params"]["conv4_2"]["kernel"],
        np.asarray(jvgg.load_npz(str(tmp_path / "vgg.npz"))
                   ["params"]["conv4_2"]["kernel"]))


@pytest.mark.parametrize("normalization", ["imagenet", "lpips"])
def test_extract_features_matches_jax(vggs, normalization):
    params, model = vggs
    x = image(3, 40, 56)
    want = jvgg.extract_features(params, jnp.asarray(x), normalization)
    with torch.no_grad():
        got = tvgg.extract_features(model, torch.from_numpy(x), normalization)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=FEAT_RTOL * np.abs(w).max())


@pytest.mark.parametrize("style", [(), (1, 2)])
def test_perceptual_loss_and_gradient_match_jax(vggs, style):
    params, model = vggs
    pred, tgt = image(4, 48, 64), image(5, 48, 64)
    jl, jg = jax.value_and_grad(lambda p: jperc.vgg_perceptual_loss(
        params, p, jnp.asarray(tgt), style_layers=style))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    tl = tperc.vgg_perceptual_loss(model, p, torch.from_numpy(tgt),
                                   style_layers=style)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    jg = np.asarray(jg)
    rel = np.linalg.norm(p.grad.numpy() - jg) / np.linalg.norm(jg)
    assert rel <= GRAD_REL_L2, rel


def test_lpips_matches_jax(vggs):
    params, model = vggs
    g = torch.Generator()
    g.manual_seed(6)
    lins = tlpips.random_lin_weights(g)
    assert [w.shape[0] for w in lins] == list(jlpips.LPIPS_CHANNELS)
    x, y = image(7, 40, 56), image(8, 40, 56)
    want = jlpips.lpips(params, [jnp.asarray(w.numpy()) for w in lins],
                        jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = tlpips.lpips(model, lins, torch.from_numpy(x), torch.from_numpy(y))
        same = tlpips.lpips(model, lins, torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert float(same) == 0.0 < float(got)


def test_lpips_weight_files(tmp_path):
    state = synthesize_torchvision_vgg16_state(np.random.default_rng(9))
    np.savez(tmp_path / "vgg16_features.npz", **state)
    assert not tlpips.lpips_available(str(tmp_path))
    rng = np.random.default_rng(10)
    np.savez(tmp_path / "lpips_vgg_lins.npz",
             **{f"lin{i}": rng.uniform(size=(1, c, 1, 1)).astype(np.float32)
                for i, c in enumerate(tlpips.LPIPS_CHANNELS)})
    assert tlpips.lpips_available(str(tmp_path)) \
        == jlpips.lpips_available(str(tmp_path)) is True
    model, lins = tlpips.load_default(str(tmp_path), device="cpu")
    jparams, jlins = jlpips.load_default(str(tmp_path))
    for a, b in zip(lins, jlins):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        convert.module_to_flax(model)["params"]["conv0_0"]["bias"],
        np.asarray(jparams["params"]["conv0_0"]["bias"]))
