"""The port's per-segment LoRA fine-tuning (`vegs_torch.diffusion.lora.
train_lora`) against vegs_tpu's.

Both trainers get the same tiny stack (`tests/test_torch_diffusion.
tiny_pair`: the port's seeded init, LoRA up-projections non-zero) and the
same draws: JAX's keys are split as its `train_lora` splits them, and each
micro-batch's crop corners, timesteps, noise and VAE eps are handed to the
port (`jax_draws`).

With `grad_accum=1` the two loops are the same algorithm (one AdamW update
per micro-batch, cosine over `steps` updates): after 2 steps the step
losses agree within 1e-5 relative, and the LoRA leaves within 1e-3 of the
learning rate on at least 98% of each leaf's elements and within 2 steps
of 2 lr on every one. Adam divides each gradient component by its own
root mean square, so a component whose gradient is near zero moves by up
to lr whatever its float32 summation order (one of 64 elements read
2.6e-3 lr here, the rest under 1e-4 lr).

With `grad_accum=4` the port applies ONE AdamW update on the mean of the 4
micro-batch gradients (checked against a plain numpy AdamW step on the
port's own per-micro-batch gradients, within 1e-4 of lr + two float32
steps of the leaf: float32 against float64), while JAX's loop applies 4 (its leaves lie several lr
away from that update).
"""

import math

import jax
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_diffusion import nchw, tiny_pair
from vegs_torch.diffusion import lora as tlora
from vegs_tpu.diffusion import lora as jlora

LR, CROP = 1e-3, 32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=3, lora_rank=2)


def images(seed=0, b=2, h=40, w=48):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, h, w)).astype(
        np.float32)


def jax_draws(imgs, steps, grad_accum, seed, latent_hw, batch_size=1):
    """JAX train_lora's draws, in its order of key splits."""
    b, _, h, w = imgs.shape
    key = jax.random.key(seed)
    out = []
    for _ in range(steps * grad_accum):
        key, sub = jax.random.split(key)
        k_crop, k_t, k_n, k_enc = jax.random.split(sub, 4)
        ks = jax.random.split(k_crop, 3)
        bi = jax.random.randint(ks[0], (batch_size,), 0, b)
        ys = jax.random.randint(ks[1], (batch_size,), 0, max(h - CROP, 1))
        xs = jax.random.randint(ks[2], (batch_size,), 0, max(w - CROP, 1))
        t = jax.random.randint(k_t, (batch_size,), 0, 1000)
        shape = (batch_size, latent_hw, latent_hw, 4)
        out.append(tlora.MicroBatchDraws(
            *(torch.from_numpy(np.array(x)).long() for x in (bi, ys, xs, t)),
            nchw(jax.random.normal(k_n, shape)),
            nchw(jax.random.normal(k_enc, shape))))
    return out


def lora_leaves(unet):
    return {n: p.detach().clone() for n, p in unet.named_parameters()
            if tlora.is_lora_path(n)}


def jax_lora_leaves(params):
    return {k: v.T for k, v in jlora.split_lora(params).items()}


def run_port(tm, imgs, draws, steps, grad_accum):
    before = lora_leaves(tm.unet)
    _, losses = tlora.train_lora(tm, imgs, steps=steps, grad_accum=grad_accum,
                                 lr=LR, crop=CROP, draws=draws)
    after = lora_leaves(tm.unet)
    with torch.no_grad():   # the fixture's stack is shared: put it back
        for n, p in tm.unet.named_parameters():
            if n in before:
                p.copy_(before[n])
    return before, after, losses


def test_grad_accum_1_matches_jax(pair):
    jm, tm = pair
    imgs = images()
    f = tm.vae.config.downsample_factor
    draws = jax_draws(imgs, 2, 1, seed=0, latent_hw=CROP // f)
    params, jlosses = jlora.train_lora(jm, imgs, steps=2, grad_accum=1, lr=LR,
                                       crop=CROP, seed=0)
    frozen = {n: p.detach().clone() for n, p in tm.unet.named_parameters()
              if not tlora.is_lora_path(n)}
    _, after, tlosses = run_port(tm, imgs, draws, 2, 1)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = jax_lora_leaves(params)
    assert {tlora.flax_lora_key(n) for n in after} == set(want)
    for n, p in after.items():
        d = np.abs(p.numpy() - want[tlora.flax_lora_key(n)])
        assert d.max() <= 2 * 2 * LR, n
        assert (d > 1e-3 * LR).mean() <= 0.02, (n, d.max() / LR)
    # the frozen weights are not moved, and get back their flags
    for n, p in tm.unet.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]) and p.requires_grad, n


def adamw_spec(p, g, lr, wd=1e-4, b1=0.9, b2=0.999, eps=1e-8):
    """One AdamW update from zero moments (optax's adamw at count 0)."""
    p, g = np.float64(p), np.float64(g)
    m_hat = (1 - b1) * g / (1 - b1)
    v_hat = (1 - b2) * g * g / (1 - b2)
    return p - lr * (m_hat / (np.sqrt(v_hat) + eps) + wd * p)


def test_grad_accum_4_is_one_update_on_the_mean_gradient(pair):
    jm, tm = pair
    imgs = images(1)
    f = tm.vae.config.downsample_factor
    draws = jax_draws(imgs, 1, 4, seed=5, latent_hw=CROP // f)
    # the port's own gradients of each micro-batch at the starting leaves
    names = [n for n, _ in tm.unet.named_parameters() if tlora.is_lora_path(n)]
    params = [dict(tm.unet.named_parameters())[n] for n in names]
    grads = [np.zeros(p.shape) for p in params]
    for d in draws:
        loss = tlora.micro_batch_loss(tm, torch.from_numpy(imgs), CROP, d)
        for acc, gi in zip(grads, torch.autograd.grad(loss, params)):
            acc += gi.double().numpy() / len(draws)
    before, after, _ = run_port(tm, imgs, draws, 1, 4)
    jparams, _ = jlora.train_lora(jm, imgs, steps=1, grad_accum=4, lr=LR,
                                  crop=CROP, seed=5)
    jleaves = jax_lora_leaves(jparams)
    far = 0
    for n, g in zip(names, grads):
        spec = adamw_spec(before[n].numpy(), g, LR)
        np.testing.assert_allclose(after[n].numpy(), spec, atol=1e-4 * LR,
                                   rtol=2.4e-7, err_msg=n)
        far = max(far, float(np.abs(jleaves[tlora.flax_lora_key(n)]
                                    - spec).max()))
    # JAX's loop made 4 updates of the leaves instead of 1
    print(f"JAX's grad_accum=4 step: up to {far / LR:.2f} lr from one "
          "AdamW update on the mean gradient")
    assert far > LR, far


def test_random_square_crops_and_schedule():
    g = torch.Generator().manual_seed(0)
    imgs = torch.from_numpy(images(2, b=3, h=20, w=30))
    crops = tlora.random_square_crops(g, imgs, 16, 5)
    assert crops.shape == (5, 3, 16, 16)
    # every crop is a window of one of the images
    for c in crops:
        hits = [(b, y, x) for b in range(3) for y in range(4) for x in range(14)
                if torch.equal(imgs[b, :, y:y + 16, x:x + 16], c)]
        assert hits
    sched = jax.jit(optax.cosine_decay_schedule(LR, 7))
    for k in range(9):
        assert math.isclose(tlora.cosine_lr(LR, k, 7), float(sched(k)),
                            rel_tol=1e-6, abs_tol=1e-12)
