"""Diffusion guidance and the perceptual term in the port's training step,
against vegs_tpu's.

Weights: the tiny diffusion stack of tests/test_torch_diffusion.py
(`tiny_pair`: the port's seeded init given to JAX, carried back with
`convert`), the port's seeded VGG16 features given to JAX likewise. Draws:
the port's guidance draws are replaced by JAX's keys, split as the JAX
Trainer (`train.py:603`) and `SDGuidance.__call__` (`sd_guidance.py:51`)
split them, NHWC draws permuted to NCHW, and carried into the port's step
on its `GuidedView` (`replay_jax_draws`).

  * `SDGuidance` in score matching (sm_lambda raised to 1e-4 so that its
    gradient is seen) and SDS: the loss and its gradient with respect to a
    [3, 32, 32] crop, at iterations where `max_step_at` anneals. Loss
    within a relative 1e-4, gradient within 1e-4 of its largest |value|.
  * The guided Trainer over 6 steps in both modes: in
    tests/test_torch_guided_train.py, with the helpers here.
  * One guided step (SDS, the perceptual term on, iteration 3) with one
    box (tests/test_torch_dynamic_train.py's scene, its second instance
    removed) on the gradients: the metrics as in the 6-step test, and the
    Adam first moments (0.1 x the gradient after one step) of the field,
    the box field and the residual within 2e-3 of each leaf's largest
    |value| (the perceptual term's ReLU and max-pool flips; measured
    4.8e-4; an isotropic Gaussian's rotation has none: zero on both).
  * The repaired fault: `--perceptual_loss` changes the port's step (it
    did nothing before), as it changes JAX's.
  * `main` with VEGS_SD_CHECKPOINT on a tiny checkpoint tree (the configs
    patched to tiny) builds the guidance and takes guided steps on the toy
    KITTI-360 root.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_diffusion import nchw, tiny_pair
from vegs_torch import convert
from vegs_torch.config import ModelParams
from vegs_torch.losses import vgg as tvgg
from vegs_torch.losses.sd_guidance import SDGuidance
from vegs_torch.ops.rasterize import RasterizeConfig
from vegs_torch.scene import Scene, dataset_readers as treaders
from vegs_torch.train import Trainer
from vegs_tpu.losses.sd_guidance import SDGuidance as JGuidance

K_CAP = 1 << 13
SEED = 7            # the Trainers' rng_seed (their default)
SM_LAMBDA = 1e-4
RTOL = 1e-4
GRAD_RTOL = 1e-4
# the box step's gradients also carry the perceptual term's: its image
# gradient differs by up to 1.5e-3 of its max where a ReLU mask or a
# max-pool choice flips (tests/test_torch_learned_losses.py); measured
# 4.8e-4 of a leaf's max
BOX_GRAD_RTOL = 2e-3
# score matching's loss is a signed sum that cancels (it crosses zero over
# the run: -2.4e-4 at one step against 4.1e-3 at the one before), so its
# metric is also held within 1e-6 absolute (measured 2.0e-7)
METRIC_ATOL = {"guidance_loss": 1e-6}
GUIDE = dict(start_iter=2, max_iters=30, max_step=50)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    return tiny_pair(seed=0, lora_rank=4)


@pytest.fixture(scope="module")
def vggs():
    g = torch.Generator()
    g.manual_seed(1)
    tree = convert.module_to_flax(tvgg.init_params(g))
    return jax.tree.map(jnp.asarray, tree), convert.vgg_from_flax(tree, "cpu")


def replay_jax_draws(trainer, seed=SEED):
    """Give the port Trainer's guided steps JAX's draws: each guided step
    splits the next subkey off `jax.random.key(seed)` as the JAX Trainer
    does, then (enc, t, noise) as JAX's SDGuidance does (`jax_draws`), at
    the step counter the guidance is called with; the draws ride on the
    step's `GuidedView`."""
    key = jax.random.key(seed)
    step_extras = trainer._step_extras

    def replayed(it, cam):
        nonlocal key
        guided, perceptual = step_extras(it, cam)
        if guided is not None:
            key, sub = jax.random.split(key)
            h = guided.cam.height
            shape = guided.guidance.latent_shape(torch.empty(3, h, h))
            guided = guided._replace(draws=jax_draws(
                guided.guidance, sub, shape, trainer.state.step))
        return guided, perceptual

    trainer._step_extras = replayed
    return trainer


def jax_draws(guidance, key, latent_shape, iteration) -> dict:
    b, c, h, w = latent_shape
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    hi = max(guidance.max_step_at(iteration), guidance.min_step)
    t = jax.random.randint(k_t, (b,), guidance.min_step, hi + 1)
    return {"eps": nchw(jax.random.normal(k_enc, (b, h, w, c))),
            "t": torch.from_numpy(np.asarray(t)).long(),
            "noise": nchw(jax.random.normal(k_noise, (b, h, w, c)))}


def guidance_pair(models, mode, **kw):
    jm, tm = models
    args = dict(GUIDE, guidance_mode=mode, sm_lambda=SM_LAMBDA, **kw)
    return JGuidance(jm, **args), SDGuidance(tm, **args)


# -- SDGuidance alone ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["score-matching", "sds"])
def test_guidance_loss_and_crop_gradient_match_jax(models, mode):
    jg, tg = guidance_pair(models, mode)
    crop = np.random.default_rng(3).uniform(size=(3, 32, 32)).astype(np.float32)
    jvg = jax.jit(jax.value_and_grad(lambda x, key, it: jg(key, x, it)))
    tops = []
    # max_step anneals 46, 24 (the jitted step's rounding), 5
    for i, it in enumerate((4, 16, 27)):
        key = jax.random.key(100 + i)
        jl, jgrad = jvg(jnp.asarray(crop), key, jnp.int32(it))
        x = torch.from_numpy(crop).requires_grad_(True)
        draws = jax_draws(tg, key, tg.latent_shape(x), it)
        tl = tg(x, it, draws=draws)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
        jgrad = np.asarray(jgrad)
        assert np.abs(jgrad).max() > 0
        np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                                   atol=GRAD_RTOL * np.abs(jgrad).max())
        tops.append(tg.max_step_at(it))
    assert tops == [46, 24, 5]


def test_guidance_draws_from_a_generator(models):
    _, tm = models
    g = SDGuidance(tm, guidance_mode="sds", **GUIDE)
    crop = torch.rand((3, 32, 32), generator=torch.Generator().manual_seed(4))
    a = g(crop, 10, generator=torch.Generator().manual_seed(5))
    b = g(crop, 10, generator=torch.Generator().manual_seed(5))
    c = g(crop, 10, generator=torch.Generator().manual_seed(6))
    assert float(a) == float(b) != float(c)
    d = g.draw(g.latent_shape(crop), 27, torch.Generator().manual_seed(7))
    assert d["eps"].shape == d["noise"].shape == (1, 4, 16, 16)
    assert 0 <= int(d["t"]) <= 5


# -- the guided Trainer ----------------------------------------------------------


def _scene_info(readers, seed=0, n_pts=150, n_cams=6):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.2, 0.8, (n_pts, 3)).astype(np.float32)
    pcd = readers.BasicPointCloud(pts, cols)
    cams = readers.generateRandomCameras(n_cams, camera_distance=4.0,
                                         width=64, height=48)
    return readers.SceneInfo(
        point_cloud=pcd, train_cameras=cams[:-1], test_cameras=cams[-1:],
        nerf_normalization=readers.getNerfppNorm(cams, pcd), ply_path="")


def _guided_cfg(cfg):
    cfg.opt.densify_from_iter = 10**9
    cfg.sd.start_guiding_from_iter = 1   # guided from iteration 2
    cfg.sd.end_guiding_at_iter = 30
    cfg.sd.sd_image_size = 32
    cfg.sd.perceptual_loss_lambda = 0.1
    return cfg


def test_guided_box_step_gradients_match_jax(models, vggs):
    from tests import test_torch_dynamic_train as dyn

    jt, tt = dyn._trainers()
    for t in (jt, tt):  # one box: drop the second instance
        for name in ("box_fields", "box_opts", "box_stats"):
            getattr(t, name).pop(dyn.B)
    for t in (jt, tt):
        _guided_cfg(t.cfg)
        t.cfg.sd.perceptual_loss = True
    jt._vgg_params, tt._vgg = vggs
    jt.sd_guidance, tt.sd_guidance = guidance_pair(models, "sds")
    replay_jax_draws(tt)
    it, cam = 3, 0   # train camera 0 sees frame 0, the box's
    jm = jt.train_iteration(it, camera=jt.scene.train_cameras[cam])
    tm = tt.train_iteration(it, camera=tt.scene.train_cameras[cam])
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, rtol=RTOL,
                                   atol=METRIC_ATOL.get(k, 1e-9), err_msg=k)
    assert jm["guidance_loss"] != 0.0

    def held(got, want, what):
        # (an isotropic Gaussian's rotation has no gradient: zero on both)
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BOX_GRAD_RTOL * np.abs(want).max(),
                                   err_msg=what)

    for k in convert.PARAM_LEAVES:
        held(tt.state.opt["mu"][k].numpy(), getattr(jt.state.opt.mu, k),
             f"static {k}")
    jbox = dyn._jax_box_state_numpy(jt)
    tbox = convert.box_state_to_numpy(tt)
    # the JAX pool pads the box to the largest box's capacity (8192), with
    # invalid rows after the port's 4096
    n = tt.box_fields[dyn.A].capacity
    valid = jbox["box_fields"][dyn.A]["valid"]
    assert not valid[n:].any()
    for k in convert.PARAM_LEAVES:
        held(tbox["box_opts"][dyn.A]["mu"][k][valid[:n]],
             jbox["box_opts"][dyn.A]["mu"][k][:n][valid[:n]], f"box {k}")
    for k, v in jbox["frame_delta_opts"][(0, dyn.A)]["mu"].items():
        held(tbox["frame_delta_opts"][(0, dyn.A)]["mu"][k], v, f"delta {k}")


# -- the repaired fault: --perceptual_loss ----------------------------------------


def test_perceptual_flag_changes_the_step():
    """`--perceptual_loss` used to be parsed and ignored by the port's
    Trainer; now the step gains the term, as the JAX step does
    (vegs_tpu/train.py:206-213; its own check is
    tests/test_training.py::test_perceptual_loss_wired)."""
    from vegs_torch.config import parse_config

    sh_dc = {}
    for flags in ([], ["--perceptual_loss", "--perceptual_loss_lambda", "0.5"]):
        cfg = parse_config(flags)
        cfg.opt.densify_from_iter = 10**9
        scene = Scene(ModelParams(), scene_info=_scene_info(treaders),
                      shuffle=False, device="cpu")
        for cam in scene.train_cameras:
            cam.image = np.full((3, 48, 64), 0.5, np.float32)
        tr = Trainer(cfg, scene, raster_cfg=RasterizeConfig(k_cap=K_CAP),
                     device="cpu")
        assert (tr._vgg is not None) == bool(flags)
        m = tr.train_iteration(1, camera=scene.train_cameras[0])
        assert ("perceptual_loss" in m) == bool(flags)
        sh_dc[bool(flags)] = tr.state.field.sh_dc.detach().clone()
    assert not torch.allclose(sh_dc[True], sh_dc[False])


# -- main with a Stable-Diffusion checkpoint --------------------------------------


def test_main_builds_guidance_from_a_checkpoint(tmp_path, monkeypatch):
    pytest.importorskip("transformers",
                        reason="the text encoder needs transformers")
    from safetensors.numpy import save_file

    from tests.test_torch_diffusion import _tiny_clip_tree
    from tests.test_torch_loaders import N_FRAMES, SEQ, START, toy_kitti360_root
    from tests.test_weight_converters import (synthesize_diffusers_unet_state,
                                              synthesize_diffusers_vae_state)
    from vegs_torch import train as ttrain
    from vegs_torch.diffusion import unet as tunet, vae as tvae

    monkeypatch.setattr(sys, "stdout", sys.stdout)  # main's safe_state
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(tunet.UNetConfig, "sd21",
                        staticmethod(tunet.UNetConfig.tiny))
    monkeypatch.setattr(tvae.VAEConfig, "sd", staticmethod(tvae.VAEConfig.tiny))
    sd = tmp_path / "sd"
    (sd / "unet").mkdir(parents=True)
    save_file(synthesize_diffusers_unet_state(tunet.UNetConfig.tiny(),
                                              np.random.default_rng(0)),
              str(sd / "unet" / "diffusion_pytorch_model.safetensors"))
    (sd / "vae").mkdir()
    save_file(synthesize_diffusers_vae_state(tvae.VAEConfig.tiny(),
                                             np.random.default_rng(1)),
              str(sd / "vae" / "diffusion_pytorch_model.safetensors"))
    _tiny_clip_tree(sd, tunet.UNetConfig.tiny().cross_attention_dim)
    monkeypatch.setenv("VEGS_SD_CHECKPOINT", str(sd))

    seen = []
    real = ttrain.Trainer.train_iteration

    def observe(self, it, camera=None):
        seen.append(real(self, it, camera))
        return seen[-1]

    monkeypatch.setattr(ttrain.Trainer, "train_iteration", observe)
    root = toy_kitti360_root(tmp_path / "root")
    monkeypatch.chdir(tmp_path)
    tr = ttrain.main(
        ["--source_path", str(root), "--model_path", str(tmp_path / "m"),
         "--data_type", "kitti360", "--seq", SEQ, "--start_frame",
         str(START), "--end_frame", str(START + N_FRAMES),
         "--iterations_override", "3", "--data_parallel", "1",
         "--k_cap", "8192", "--test_iterations", "100",
         "--start_guiding_from_iter", "1", "--end_guiding_at_iter", "10",
         "--sd_image_size", "32", "--guidance_mode", "sds"], device="cpu")
    assert isinstance(tr.sd_guidance, SDGuidance)
    assert tr.sd_guidance.guidance_mode == "sds"
    assert tr.sd_guidance.models.unet.config == tunet.UNetConfig.tiny()
    assert tr.sd_guidance.models.text_embeddings.shape == (2, 64, 32)
    assert [("guidance_loss" in m) for m in seen] == [False, True, True]
    assert all(np.isfinite(m["guidance_loss"]) for m in seen[1:])
