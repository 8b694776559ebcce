"""The port's optimizer, densification, losses and field plumbing against
vegs_tpu (the counterparts of tests/test_train_core.py).

Tolerances: float32 results of the same formulas evaluated in another
order agree to rtol 1e-5 (Adam, densify, normal guidance); SSIM at 128x256
to 1e-5 in value and 1e-4 of the largest gradient (the 11x11 convolutions
sum 121 products in another order); split children take the JAX package's
own normal draws, fed in, so densification is compared row for row.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vegs_tpu import densify as jden, gaussians as jgauss, optim as jopt
from vegs_tpu.config import OptimizationParams as JOptParams
from vegs_tpu.losses import (l1_loss as jl1, loss_normal_guidance as jng,
                             psnr as jpsnr, ssim as jssim)
from vegs_torch import convert, densify, gaussians, optim
from vegs_torch.config import OptimizationParams
from vegs_torch.losses import l1_loss, loss_normal_guidance, psnr, ssim
from vegs_torch.losses.photometric import l2_loss
from vegs_torch.ops.rasterize import RasterizeConfig
from vegs_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _points(rng, n=64):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, cols


def _both_fields(rng, n=64, cap=128):
    pts, cols = _points(rng, n)
    jf = jgauss.create_from_points(pts, cols, capacity=cap)
    tf = gaussians.create_from_points(pts, cols, capacity=cap, device="cpu")
    return jf, tf


def _field_arrays(f):
    return {k: np.asarray(getattr(f, k).detach() if isinstance(
        getattr(f, k), torch.Tensor) else getattr(f, k))
        for k in convert.FIELD_KEYS}


def test_create_from_points_matches_jax(rng):
    jf, tf = _both_fields(rng)
    a, b = _field_arrays(jf), _field_arrays(tf)
    for k in convert.FIELD_KEYS:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert tf.capacity == 128 and int(tf.num_active()) == 64
    ops = tf.opacities().detach().numpy()
    np.testing.assert_allclose(ops[:64, 0], 0.1, atol=1e-5)
    np.testing.assert_array_equal(ops[64:], 0.0)
    s = tf.scales().detach().numpy()
    assert (s[:64] > 0).all() and (s[:64] <= np.sqrt(0.2) + 1e-6).all()
    # box clip: a range of scales, not one value
    pts = rng.normal(size=(64, 3)).astype(np.float32) * 0.02
    box = gaussians.create_from_points(pts, capacity=64,
                                       scale_clip=(1e-7, 1e-4), device="cpu")
    s = box.scales().detach().numpy()
    assert s.min() >= np.sqrt(1e-7) - 1e-9 and s.max() <= np.sqrt(1e-4) + 1e-9
    assert np.unique(np.round(s, 8)).size > 1
    g = torch.Generator().manual_seed(0)
    rnd = gaussians.create_random(g, 50, extent=2.0, device="cpu")
    assert int(rnd.num_active()) == 50 and rnd.means.abs().max() <= 2.0
    assert gaussians.sh_band_mask(2).sum() == 9


def test_expon_lr_and_field_lrs_match_jax():
    for step in (0, 1, 500, 999, 1000, 5000):
        for delay in (0, 100):
            np.testing.assert_allclose(
                optim.expon_lr(step, 1e-3, 1e-5, lr_delay_steps=delay,
                               lr_delay_mult=0.01, max_steps=1000),
                float(jopt.expon_lr(step, 1e-3, 1e-5, lr_delay_steps=delay,
                                    lr_delay_mult=0.01, max_steps=1000)),
                rtol=1e-5)
    assert optim.expon_lr(-1, 1e-3, 1e-5) == 0.0
    for step in (0, 7, 29_000):
        a = optim.field_lrs(OptimizationParams(), 3.5, step)
        b = jopt.field_lrs(JOptParams(), 3.5, step)
        np.testing.assert_allclose(np.array(a), np.array([float(x) for x in b]),
                                   rtol=1e-5)


def test_adam_matches_jax_and_descends(rng):
    jf, tf = _both_fields(rng)
    jstate = jopt.adam_init(jf)
    tstate = optim.adam_init(tf)
    lrs = optim.field_lrs(OptimizationParams(), 1.0, 0)._replace(means=0.05)
    jlrs = jopt.field_lrs(JOptParams(), 1.0, 0)._replace(means=jnp.float32(0.05))
    target = rng.normal(size=(128, 3)).astype(np.float32)
    valid = np.asarray(jf.valid)[:, None]
    for _ in range(30):
        g = {k: np.zeros_like(np.asarray(getattr(jf, k)))
             for k in jopt.PARAM_LEAVES}
        g["means"] = (2 * (np.asarray(jf.means) - target) * valid).astype(np.float32)
        g["sh_dc"] = rng.normal(size=g["sh_dc"].shape).astype(np.float32)
        jf, jstate = jopt.adam_step(jf, {k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jlrs)
        optim.adam_step(tf, {k: _t(v) for k, v in g.items()}, tstate, lrs)
    for k in jopt.PARAM_LEAVES:
        np.testing.assert_allclose(getattr(tf, k).detach().numpy(),
                                   np.asarray(getattr(jf, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tstate["nu"][k].numpy(),
                                   np.asarray(getattr(jstate.nu, k)),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    assert int(tstate["count"]) == int(jstate.count) == 30
    loss = float((((tf.means.detach().numpy() - target) * valid) ** 2).sum())
    loss0 = float((((np.asarray(_both_fields(np.random.default_rng(0))[0].means)
                     - target) * valid) ** 2).sum())
    assert loss < 0.5 * loss0


def _stats(accum, denom, radii=None, cap=128):
    z = np.zeros(cap, np.float32) if radii is None else radii
    return (jgauss.DensifyStats(max_radii2d=jnp.asarray(z),
                                xyz_gradient_accum=jnp.asarray(accum),
                                denom=jnp.asarray(denom)),
            gaussians.DensifyStats(max_radii2d=_t(z),
                                   xyz_gradient_accum=_t(accum),
                                   denom=_t(denom)))


def _compare_densified(jres, tres):
    jf, jo, js, jn = jres
    tf, to, ts, tn = tres
    assert tn == jn and tf.capacity == jf.capacity
    a, b = _field_arrays(jf), _field_arrays(tf)
    for k in convert.FIELD_KEYS:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for m in ("mu", "nu"):
        for k in optim.PARAM_LEAVES:
            np.testing.assert_array_equal(to[m][k].numpy(),
                                          np.asarray(getattr(getattr(jo, m), k)))
    assert int(to["count"]) == int(jo.count)
    assert float(ts.denom.sum()) == 0.0


def test_densify_clone_and_split_with_fed_draws(rng):
    jf, tf = _both_fields(rng)
    accum = np.zeros(128, np.float32)
    accum[:8] = 1.0
    js, ts = _stats(accum, np.ones(128, np.float32))
    big = np.array(jf.log_scales)
    big[:4] = np.log(0.5)  # large vs percent_dense * extent -> split
    jf = jf.replace(log_scales=jnp.asarray(big))
    tf.log_scales.data = _t(big)
    jst = jopt.adam_init(jf)
    jst = jopt.AdamState(mu=jst.mu.replace(means=jnp.ones_like(jst.mu.means)),
                         nu=jst.nu, count=jnp.int32(5))
    tst = optim.adam_init(tf)
    tst["mu"]["means"] += 1.0
    tst["count"] = torch.tensor(5, dtype=torch.int32)
    key = jax.random.key(0)
    draws = np.asarray(jax.random.normal(key, (2, 128, 3)))
    kw = dict(grad_threshold=0.5, percent_dense=0.01, extent=1.0)
    jres = jden.densify_and_prune(jf, jst, js, key, **kw)
    tres = densify.densify_and_prune(tf, tst, ts, noise=_t(draws), **kw)
    assert tres[3] == 72  # 64 - 4 split parents + 4 clones + 8 children
    _compare_densified(jres, tres)
    s_new = tres[0].scales().detach().numpy()[tres[0].valid.numpy()]
    assert s_new.max() < 0.5 - 1e-3 and np.isclose(s_new, 0.5 / 1.6, atol=1e-4).any()
    # with a generator the children are drawn on the field's device
    g = torch.Generator().manual_seed(3)
    f3, _, _, n3 = densify.densify_and_prune(tf, tst, ts, g, **kw)
    assert n3 == 72 and torch.isfinite(f3.means).all()


def test_prune_and_reset_opacity_match_jax(rng):
    jf, tf = _both_fields(rng)
    logits = np.array(jf.opacity_logit)
    logits[:10] = -10.0  # opacity ~ 4.5e-5 < 0.005
    jf = jf.replace(opacity_logit=jnp.asarray(logits))
    tf.opacity_logit.data = _t(logits)
    js, ts = _stats(np.zeros(128, np.float32), np.zeros(128, np.float32))
    key = jax.random.key(1)
    kw = dict(grad_threshold=1e9, percent_dense=0.01, extent=1.0)
    jres = jden.densify_and_prune(jf, jopt.adam_init(jf), js, key, **kw)
    tres = densify.densify_and_prune(tf, optim.adam_init(tf), ts,
                                     torch.Generator(), **kw)
    assert tres[3] == 54
    _compare_densified(jres, tres)
    pj = jden.prune_only(jf, jopt.adam_init(jf), js, key, extent=1.0)
    pt = densify.prune_only(tf, optim.adam_init(tf), ts, extent=1.0)
    _compare_densified(pj, pt)

    st = optim.adam_init(tf)
    st["mu"]["opacity_logit"] += 2.0
    f2, s2 = densify.reset_opacity(tf, st)
    jf2, _ = jden.reset_opacity(jf, jopt.adam_init(jf))
    np.testing.assert_allclose(f2.opacity_logit.detach().numpy(),
                               np.asarray(jf2.opacity_logit), rtol=1e-6)
    ops = f2.opacities().detach().numpy()[f2.valid.numpy()]
    assert ops.max() <= 0.01 + 1e-5
    assert not s2["mu"]["opacity_logit"].any()
    assert float(st["mu"]["opacity_logit"].min()) == 2.0  # input untouched


def test_ssim_psnr_l1_match_jax_value_and_gradient(rng):
    a = rng.uniform(0, 1, (3, 128, 256)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta = _t(a).requires_grad_(True)
    s = ssim(ta, _t(b))
    s.backward()
    sj, gj = jax.value_and_grad(lambda x: jssim(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(float(s.detach()), float(sj), rtol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(float(psnr(_t(a), _t(b))),
                               float(jpsnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    m = np.zeros((1, 128, 256), np.float32)
    m[:, :64] = 1
    np.testing.assert_allclose(
        float(l1_loss(_t(a), _t(b), mask=_t(m))),
        float(jl1(jnp.asarray(a), jnp.asarray(b), mask=jnp.asarray(m))),
        rtol=1e-5)
    assert float(ssim(_t(a), _t(a))) > 0.999 and float(psnr(_t(a), _t(a))) > 60
    x = _t(rng.normal(size=(3, 8, 8)).astype(np.float32)).requires_grad_(True)
    l2_loss(x, torch.zeros_like(x)).backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * x.detach().numpy() / x.numel(),
                               atol=1e-6)


def test_normal_guidance_matches_jax(rng):
    q = rng.normal(size=(4, 8, 12)).astype(np.float32)
    s = rng.uniform(1e-4, 0.2, (3, 8, 12)).astype(np.float32)
    n = rng.normal(size=(3, 8, 12)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    tq, ts = _t(q).requires_grad_(True), _t(s).requires_grad_(True)
    loss = loss_normal_guidance(tq, ts, _t(n))
    loss.backward()
    lj, (gq, gs) = jax.value_and_grad(
        lambda a, b: jng(a, b, jnp.asarray(n)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(s))
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=1e-4,
                               atol=1e-7)
    # a flat first axis aligned with the normal is cheaper than misaligned
    quat = _t(np.broadcast_to(np.array([1.0, 0, 0, 0], np.float32)[:, None, None],
                              (4, 8, 8)).copy())
    scale = _t(np.broadcast_to(np.array([1e-5, 0.1, 0.1], np.float32)[:, None, None],
                               (3, 8, 8)).copy())
    flat = _t(np.broadcast_to(np.array([1.0, 0, 0], np.float32)[:, None, None],
                              (3, 8, 8)).copy())
    big = _t(np.broadcast_to(np.array([0, 1.0, 0], np.float32)[:, None, None],
                             (3, 8, 8)).copy())
    assert loss_normal_guidance(quat, scale, flat) < loss_normal_guidance(
        quat, scale, big)


def test_adapt_k_cap_grows_decays_and_stops_at_its_ceiling():
    tr = Trainer.__new__(Trainer)          # the capacity logic only
    tr.raster_cfg = RasterizeConfig(k_cap=1 << 17)
    tr._adapt_k_cap(num_dropped=10.0, num_needed=float(1 << 17))
    assert tr.raster_cfg.k_cap == 1 << 18 and tr.raster_cfg.k_pad == 1 << 18
    for _ in range(Trainer.K_CAP_DECAY_WINDOW):
        assert tr.raster_cfg.k_cap == 1 << 18
        tr._adapt_k_cap(num_dropped=0.0, num_needed=1000.0)
    assert tr.raster_cfg.k_cap == 1 << 17
    # one busy frame inside the window resets the streak
    for _ in range(Trainer.K_CAP_DECAY_WINDOW - 1):
        tr._adapt_k_cap(num_dropped=0.0, num_needed=1000.0)
    tr._adapt_k_cap(num_dropped=0.0, num_needed=float(1 << 16))
    for _ in range(Trainer.K_CAP_DECAY_WINDOW - 1):
        tr._adapt_k_cap(num_dropped=0.0, num_needed=1000.0)
    assert tr.raster_cfg.k_cap == 1 << 17
    tr._adapt_k_cap(num_dropped=0.0, num_needed=1000.0)
    assert tr.raster_cfg.k_cap == 1 << 16
    # never below the floor
    tr.raster_cfg = RasterizeConfig(k_cap=Trainer.K_CAP_MIN)
    for _ in range(Trainer.K_CAP_DECAY_WINDOW + 1):
        tr._adapt_k_cap(num_dropped=0.0, num_needed=100.0)
    assert tr.raster_cfg.k_cap == Trainer.K_CAP_MIN
    # never above the ceiling: drops at the ceiling keep both capacities
    tr.raster_cfg = RasterizeConfig(k_cap=Trainer.K_CAP_MAX // 2,
                                    k_pad=Trainer.K_CAP_MAX // 4)
    for _ in range(3):
        tr._adapt_k_cap(num_dropped=5.0, num_needed=1e9, num_needed_raw=1e9)
    assert tr.raster_cfg.k_cap == Trainer.K_CAP_MAX
    assert tr.raster_cfg.k_pad == Trainer.K_CAP_MAX
