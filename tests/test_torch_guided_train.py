"""The guided Trainer against the JAX Trainer over 6 steps, in score
matching and in SDS (the helpers, weights and draws of
tests/test_torch_guidance.py).

The toy scene of tests/test_training.py:19-45 (64x48, 150 points,
densification off), `sd_image_size` 32, the perceptual term on (lambda
0.1), the window open from iteration 2, the port's guidance draws replaced
by JAX's keys: 6 `train_iteration`s of each Trainer (the JAX one on its
dense backend; the port's tile path runs the plain versions of K1-K4).
The metrics (guidance_loss and perceptual_loss too) within a relative
1e-4 (score matching's guidance_loss, a cancelling signed sum, also within
1e-6 absolute; measured 2.0e-7), and after each step the field and its
Adam moments within 1e-4 (float32 sums in another order through two
renders, the VAE, the UNet and VGG16, amplified by Adam; the same bound as
tests/test_torch_train.py; measured 3.9e-5).
"""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_guidance import (  # noqa: F401  (fixtures)
    K_CAP, METRIC_ATOL, RTOL, _few_threads, _guided_cfg, _scene_info,
    guidance_pair, models, replay_jax_draws, vggs)
from vegs_torch import convert
from vegs_torch.config import ModelParams
from vegs_torch.losses import vgg as tvgg
from vegs_torch.ops.rasterize import RasterizeConfig
from vegs_torch.scene import Scene, dataset_readers as treaders
from vegs_torch.train import Trainer
from vegs_tpu.config import VegsConfig as JConfig
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.train import Trainer as JTrainer, eval_render

PARAM_ATOL = 1e-4


def _np_state(state):
    return {"field": {k: np.asarray(getattr(state.field, k))
                      for k in convert.FIELD_KEYS},
            "opt": {**{m: {k: np.asarray(getattr(getattr(state.opt, m), k))
                           for k in convert.PARAM_LEAVES}
                       for m in ("mu", "nu")}, "count": int(state.opt.count)}}


def _guided_trainers(models, vggs, mode):
    """(JAX Trainer, port Trainer) from the same state, guided in `mode`
    with the perceptual term on."""
    jcfg = _guided_cfg(JConfig())
    jraster = JRaster(backend="dense", k_cap=K_CAP)
    js = JScene(jcfg.model, scene_info=_scene_info(jreaders), shuffle=False)
    jt = JTrainer(jcfg, js, raster_cfg=jraster)
    for cam in js.train_cameras + js.test_cameras:
        cam.image = np.clip(np.asarray(eval_render(
            jt.state.field, cam.device_params(), jt.bg, 3, jraster).rgb), 0, 1)
    f = jt.state.field
    jt.state = jt.state.replace(field=f.replace(sh_dc=f.sh_dc + 0.35))
    # the flag after construction, so that Flax does not init VGG16 (slow)
    jcfg.sd.perceptual_loss = True
    jt._vgg_params = vggs[0]
    jt.sd_guidance, tg = guidance_pair(models, mode)

    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ts = Scene(ModelParams(), scene_info=_scene_info(treaders), shuffle=False,
               device="cpu")
    for tc, jc in zip(ts.train_cameras + ts.test_cameras,
                      js.train_cameras + js.test_cameras):
        tc.image = jc.image
    tt = replay_jax_draws(Trainer(tcfg, ts,
                                  raster_cfg=RasterizeConfig(k_cap=K_CAP),
                                  device="cpu", sd_guidance=tg))
    assert isinstance(tt._vgg, tvgg.VGG16Features)  # the flag's own init
    tt._vgg = vggs[1]
    tt.state = convert.train_state_from_numpy(
        {**_np_state(jt.state), "stats": {k: np.asarray(getattr(
            jt.state.stats, k)) for k in convert.STATS_KEYS},
         "step": int(jt.state.step)}, device="cpu")
    ts.gaussians = tt.state.field
    return jt, tt


@pytest.mark.parametrize("mode", ["score-matching", "sds"])
def test_guided_trainer_matches_jax_over_six_steps(models, vggs, mode):
    jt, tt = _guided_trainers(models, vggs, mode)
    js, ts = jt.scene, tt.scene
    for it in range(1, 7):
        jm = jt.train_iteration(it, camera=js.train_cameras[it % 5])
        tm = tt.train_iteration(it, camera=ts.train_cameras[it % 5])
        guided = it >= 2
        assert ("guidance_loss" in jm) == ("guidance_loss" in tm) == guided
        assert "perceptual_loss" in jm and "perceptual_loss" in tm
        for k, v in jm.items():
            np.testing.assert_allclose(tm[k], v, rtol=RTOL,
                                       atol=METRIC_ATOL.get(k, 1e-9),
                                       err_msg=f"{k} at {it}")
        if guided:
            assert tm["guidance_loss"] != 0.0 and tm["aug_num_dropped"] == 0
        want = _np_state(jt.state)
        got = convert.train_state_to_numpy(tt.state)
        for part in ("field", "opt"):
            for k in convert.PARAM_LEAVES:
                w = want[part][k] if part == "field" else None
                pairs = ([(got["field"][k], w)] if part == "field" else
                         [(got["opt"][m][k], want["opt"][m][k])
                          for m in ("mu", "nu")])
                for g, w in pairs:
                    np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                               err_msg=f"{part} {k} at {it}")
    assert tt.state.step == int(jt.state.step) == 6
