"""The tiny SD stack's per-scene pretraining (vegs_torch/perf/quality.py
`pretrain_unet`, `pretrain_vae`) against the JAX package's
(perf/quality_full_r04.py:45 `pretrain_unet`, perf/quality_full_r05.py:103
`pretrain_vae`, loaded by path), one AdamW step each.

Both packages get the same weights (`tests/test_torch_diffusion.tiny_pair`:
the port's seeded tiny stack carried to Flax by `convert` and back) and
the same draws: JAX's keys are split as its loops split them, and each
step's crop corners, timesteps, noise and encoder eps are handed to the
port. The step's loss within 1e-5 relative. The first AdamW step moves a
component by lr g / (|g| + eps) (lr 2e-4, eps 1e-8), so where |g| >> eps
the step is +-lr whatever the float32 summation order: every such
("saturated", the port's step at least 0.99 lr) parameter after the step
within 1e-6 (read: 3e-8). Where |g| is within ~100 eps of zero the step
follows the float32 noise in g; those components (4.4% of the UNet's,
1.5% of the VAE's; a VAE attention key bias has a zero gradient in exact
arithmetic and a rounding residue in float32) are held within 0.2 lr: two
gradients of one sign within a factor of 2 of each other step at most
0.172 lr apart (read: 0.072 lr). The frozen half (the VAE while the UNet
trains, and the other way) is not moved.
"""

import importlib.util
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_diffusion import nchw, tiny_pair
from tests.test_torch_lora_train import jax_draws
from vegs_torch import convert
from vegs_torch.diffusion import lora as tlora
from vegs_torch.perf import quality as q

ROOT = Path(__file__).resolve().parents[1]
BATCH, CROP = 8, 32
LR = 2e-4                       # the pretraining's (unscheduled) first rate
LOSS_RTOL, PARAM_ATOL, UNSAT_ATOL = 1e-5, 1e-6, 0.2 * LR


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """perf/quality_full_r04.py and quality_full_r05.py as modules (their
    imports set environment variables and extend sys.path: restored)."""
    env, path = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(
        tmp_path_factory.mktemp("jax_cache"))
    os.environ["VEGS_QUALITY_BACKEND"] = "dense"
    mods = {}
    try:
        sys.path.insert(0, str(ROOT / "perf"))
        for name in ("quality_full", "quality_full_r04", "quality_full_r05"):
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "perf" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            sys.modules[name] = mods[name]
            spec.loader.exec_module(mods[name])
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mods["quality_full_r04"], mods["quality_full_r05"]


def images(seed=0, b=3, h=40, w=48):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, h, w)).astype(
        np.float32)


def jax_vae_draws(imgs, seed, latent_hw):
    """quality_full_r05.py's draws of its first step: the crops' corners
    from k_crop, the encoder's eps from k_enc (t and noise unused)."""
    b, _, h, w = imgs.shape
    _, sub = jax.random.split(jax.random.key(seed))
    k_crop, k_enc = jax.random.split(sub)
    ks = jax.random.split(k_crop, 3)
    corners = [jax.random.randint(ks[0], (BATCH,), 0, b),
               jax.random.randint(ks[1], (BATCH,), 0, max(h - CROP, 1)),
               jax.random.randint(ks[2], (BATCH,), 0, max(w - CROP, 1))]
    eps = nchw(jax.random.normal(k_enc, (BATCH, latent_hw, latent_hw, 4)))
    zeros = torch.zeros(BATCH, dtype=torch.long)
    return tlora.MicroBatchDraws(
        *(torch.from_numpy(np.array(x)).long() for x in corners), zeros,
        torch.zeros_like(eps), eps)


def flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, tree))[0])


def assert_step_close(before, module, tree, msg):
    """The port's parameters after the step (`module`) against JAX's
    (`tree`), both from `before` (module docstring)."""
    got, want = flat(convert.module_to_flax(module)), flat(tree)
    assert got.keys() == want.keys() == before.keys(), msg
    for k, v in got.items():
        sat = np.abs(v - before[k]) >= 0.99 * LR
        d = np.abs(v - want[k])
        name = f"{msg} {jax.tree_util.keystr(k)}"
        assert d[sat].max(initial=0) <= PARAM_ATOL, name
        assert d[~sat].max(initial=0) <= UNSAT_ATOL, name


def frozen(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def test_pretrain_unet_one_step_matches_jax(scripts):
    qf4, _ = scripts
    jm, tm = tiny_pair(seed=4, lora_rank=0)
    imgs = images()
    f = tm.vae.config.downsample_factor
    draws = jax_draws(imgs, 1, 1, seed=0, latent_hw=CROP // f,
                      batch_size=BATCH)
    vae_before = frozen(tm.vae)
    before = flat(jm.unet_params)
    jm2, jlosses = qf4.pretrain_unet(jm, imgs, steps=1, lr=LR)
    tm2, tlosses = q.pretrain_unet(tm, imgs, steps=1, lr=LR, draws=draws)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert_step_close(before, tm2.unet, jm2.unet_params, "unet")
    for n, p in tm2.vae.named_parameters():
        assert torch.equal(p, vae_before[n]), n


def test_pretrain_vae_one_step_matches_jax(scripts):
    _, qf5 = scripts
    jm, tm = tiny_pair(seed=5, lora_rank=0)
    imgs = images(1)
    f = tm.vae.config.downsample_factor
    draws = [jax_vae_draws(imgs, seed=1, latent_hw=CROP // f)]
    unet_before = frozen(tm.unet)
    before = flat(jm.vae_params)
    jm2, (jfirst, _) = qf5.pretrain_vae(jm, imgs, steps=1, lr=LR)
    tm2, (tfirst, _) = q.pretrain_vae(tm, imgs, steps=1, lr=LR, draws=draws)
    np.testing.assert_allclose(tfirst, jfirst, rtol=LOSS_RTOL)
    assert_step_close(before, tm2.vae, jm2.vae_params, "vae")
    for n, p in tm2.unet.named_parameters():
        assert torch.equal(p, unet_before[n]), n


def test_pretrain_own_draws_lower_the_loss():
    """The port's own draws (a seeded generator on the models' device):
    the losses are finite and fall over 30 steps on a fixed image set."""
    g = torch.Generator().manual_seed(0)
    from vegs_torch.diffusion.pipeline import DiffusionModels

    m = DiffusionModels.tiny(g)
    imgs = images(2, b=2)
    m, ul = q.pretrain_unet(m, imgs, steps=30, lr=1e-3)
    m, vl = q.pretrain_vae(m, imgs, steps=30, lr=1e-3)
    assert len(ul) == 2 and np.isfinite(ul).all() and ul[-1] < ul[0]
    assert np.isfinite(vl).all() and vl[1] < vl[0]
    # the flags are put back
    assert all(p.requires_grad for p in m.unet.parameters())
    assert all(p.requires_grad for p in m.vae.parameters())
