"""The port's static Trainer end to end on the toy scene of
tests/test_training.py:19 (150 points, 5 train + 1 test random cameras at
48x64).

  * Against the JAX Trainer (dense backend, as tests/test_training.py:16):
    both start from the same state (the JAX field converted with
    `convert.train_state_from_numpy`), see the same ground truth and the
    same camera each iteration, and take 6 steps with one densify event at
    iteration 5 that only clones (percent_dense = 1 makes every
    high-gradient Gaussian "small"). The port runs its main path on the CPU:
    the tile backend, i.e. the plain versions of kernels K1-K4. The grad
    threshold is set, before the event, in the widest gap of the JAX run's
    average gradients, so that no Gaussian sits on the edge of the decision.
    Tolerance: losses within rtol 1e-4, every parameter within 1e-4
    (float32 sums in another order, amplified by six Adam steps; measured
    <= 6e-6), the same capacity, active count and validity mask.
  * The port's own `test_static_training_descends`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vegs_tpu.config import VegsConfig as JConfig
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.train import Trainer as JTrainer, eval_render
from vegs_torch import convert
from vegs_torch.config import VegsConfig
from vegs_torch.ops.rasterize import RasterizeConfig
from vegs_torch.render import render
from vegs_torch.scene import Scene, dataset_readers as treaders
from vegs_torch.train import Trainer

K_CAP = 1 << 13


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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


def _schedule(cfg):
    cfg.opt.densify_from_iter = 4
    cfg.opt.densification_interval = 5
    cfg.opt.densify_until_iter = 100
    cfg.opt.opacity_reset_interval = 10_000
    cfg.opt.percent_dense = 1.0
    return cfg


def _jax_state_numpy(state):
    return {
        "field": {k: np.asarray(getattr(state.field, k))
                  for k in convert.FIELD_KEYS},
        "opt": {**{m: {k: np.asarray(getattr(getattr(state.opt, m), k))
                       for k in convert.PARAM_LEAVES} for m in ("mu", "nu")},
                "count": int(state.opt.count)},
        "stats": {k: np.asarray(getattr(state.stats, k))
                  for k in convert.STATS_KEYS},
        "step": int(state.step),
    }


def test_trainer_matches_jax_over_six_steps_with_a_densify_event():
    jcfg = _schedule(JConfig())
    jraster = JRaster(backend="dense", k_cap=K_CAP)
    js = JScene(jcfg.model, scene_info=_scene_info(jreaders), shuffle=False)
    jt = JTrainer(jcfg, js, raster_cfg=jraster)
    for cam in js.train_cameras + js.test_cameras:
        cam.image = np.clip(np.asarray(eval_render(
            jt.state.field, cam.device_params(), jt.bg, 3, jraster).rgb), 0, 1)
    f = jt.state.field
    jt.state = jt.state.replace(field=f.replace(sh_dc=f.sh_dc + 0.35))

    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ts = Scene("", _scene_info(treaders), load_iteration=None, shuffle=False,
               device="cpu")
    for tc, jc in zip(ts.train_cameras + ts.test_cameras,
                      js.train_cameras + js.test_cameras):
        tc.image = jc.image
    tt = Trainer(tcfg, ts, raster_cfg=RasterizeConfig(k_cap=K_CAP),
                 device="cpu")
    tt.state = convert.train_state_from_numpy(_jax_state_numpy(jt.state),
                                              device="cpu")
    ts.gaussians = tt.state.field
    n0 = int(tt.state.field.num_active())

    jl, tl = [], []
    for it in range(1, 7):
        if it == 5:  # the densify event: pick the threshold in a wide gap
            st = jt.state.stats
            avg = (np.asarray(st.xyz_gradient_accum)
                   / np.maximum(np.asarray(st.denom), 1.0))
            v = np.sort(avg[np.asarray(jt.state.field.valid) & (avg > 0)])
            lo, hi = int(0.3 * len(v)), int(0.7 * len(v))
            i = lo + int(np.argmax(v[lo + 1:hi] / v[lo:hi - 1]))
            assert v[i + 1] / v[i] > 1.01
            thr = float(np.sqrt(v[i] * v[i + 1]))
            jcfg.opt.densify_grad_threshold = thr
            tcfg.opt.densify_grad_threshold = thr
        jl.append(jt.train_iteration(it, camera=js.train_cameras[it % 5])["loss"])
        tl.append(tt.train_iteration(it, camera=ts.train_cameras[it % 5])["loss"])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tt.state.step == int(jt.state.step) == 6
    assert tt.state.field.capacity == jt.state.field.capacity
    n1 = int(tt.state.field.num_active())
    assert n1 == int(jt.state.field.num_active()) > n0  # clones were made
    got = convert.field_to_numpy(tt.state.field)
    for k in convert.FIELD_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jt.state.field, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    back = convert.train_state_to_numpy(tt.state)
    assert back["step"] == 6 and back["opt"]["count"] == 6
    np.testing.assert_allclose(back["opt"]["mu"]["means"],
                               np.asarray(jt.state.opt.mu.means), rtol=0,
                               atol=1e-4)


def test_static_training_descends():
    cfg = VegsConfig()
    cfg.opt.densify_from_iter = 10**9  # pure optimisation
    raster = RasterizeConfig(k_cap=K_CAP)
    scene = Scene("", _scene_info(treaders), load_iteration=None,
                  shuffle=False, device="cpu")
    tr = Trainer(cfg, scene, raster_cfg=raster, device="cpu")
    with torch.no_grad():
        for cam in scene.train_cameras + scene.test_cameras:
            out = render(cam, tr.state.field,
                         config=raster._replace(forward_only=True))
            cam.image = np.clip(out.rgb.numpy(), 0, 1)
        tr.state.field.sh_dc += 0.35  # something to learn
    losses = [tr.train_iteration(it)["loss"] for it in range(1, 41)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
    e = tr.evaluate(with_ssim=True)
    assert e["psnr"] > 22 and 0.0 < e["ssim"] <= 1.0
    log = tr.train(iterations=4, log_every=2)
    assert [m["iter"] for m in log] == [2, 4]


def test_trainer_needs_its_device(monkeypatch):
    scene = Scene("", _scene_info(treaders), load_iteration=None,
                  shuffle=False, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        Trainer(VegsConfig(), scene, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(VegsConfig(), scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scene("", _scene_info(treaders), load_iteration=None, shuffle=False)
