"""The port's quality harness (vegs_torch/perf/quality.py) against the JAX
package's (perf/quality_full.py, quality_r02.py, quality_full_r04.py,
quality_full_r05.py, quality_box_r05.py), loaded by path with
VEGS_QUALITY_BACKEND=dense at a toy size: 32x64, 9 cameras (the idx % 8
split holds cameras 0 and 8 out).

  * `build_scene_info`, mono and stereo (3 frames x 2 eyes), from the same
    numpy seed: the point cloud, the dynamic cloud, the true and noisy
    box-to-world per frame, the cameras' poses and intrinsics equal to the
    bit (the same numpy code); the ray-traced images and normal maps
    within 1e-6 (float32 ray tracing in numpy on both sides).
  * `make_aug_cameras`: poses equal to the bit, re-traced images within
    1e-6.
  * The configs of arms A-E, of the static recipe and of the stereo box
    run equal the JAX scripts' field by field (all but model_path), with
    the same k_cap and Trainer seed.
  * `box_pose_errors` on the same seeded deltas within 1e-6 m.
  * Arms A and D, 10 iterations (no densify event) on each package's own
    scene and Trainer (the port's plain kernels on the CPU, JAX's dense
    backend): the held-out PSNR with the boxes within 0.01 dB, the same
    active Gaussians. Both Trainers run at k_cap 2^14 instead of the
    arms' 2^17: JAX's dense spec is O(k_cap x pixels) (25 s a step at
    2^17 here, 2.5 s at 2^14), and this scene needs at most ~9.3k raw and
    ~11.5k padded slots, so nothing is dropped at either capacity.
  * A trunk-and-branch round trip on arm D's Trainer (a densify at
    iteration 5, inside the branch): trunk 3 steps, snapshot, 3 steps,
    restore, 3 steps; the second branch equals the first to the bit (the
    port's Adam updates fields and moments in place, so a snapshot of
    references would follow the branch).
"""

import dataclasses
import importlib.util
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vegs_torch import boxmodel as tbox
from vegs_torch.perf import quality as q

ROOT = Path(__file__).resolve().parents[1]
H, W, N_CAMS = 32, 64, 9
IMG_ATOL = 1e-6
K_CAP = 1 << 14  # the 10-iteration comparison's capacity (module docstring)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def load_jax_scripts(cache_dir):
    """perf/quality_full.py, quality_r02.py, quality_full_r04.py and
    quality_full_r05.py as modules, on the dense backend. Their imports set
    environment variables and extend sys.path: both are restored."""
    env, path = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    os.environ["VEGS_QUALITY_BACKEND"] = "dense"
    mods = {}
    try:
        sys.path.insert(0, str(ROOT / "perf"))
        for name in ("quality_full", "quality_r02", "quality_full_r04",
                     "quality_full_r05"):
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "perf" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            sys.modules[name] = mods[name]  # r04 and r05 import quality_full
            spec.loader.exec_module(mods[name])
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    # the extrapolated views place the mover by r04's camera count
    mods["quality_full_r04"].N_CAMS = N_CAMS
    return types.SimpleNamespace(qf=mods["quality_full"], r02=mods["quality_r02"],
                                 qf4=mods["quality_full_r04"],
                                 qf5=mods["quality_full_r05"])


@pytest.fixture(scope="module")
def jq(tmp_path_factory):
    return load_jax_scripts(tmp_path_factory.mktemp("jax_cache"))


@pytest.fixture(scope="module")
def scenes(jq):
    """{stereo baseline: (JAX scene, port scene)}; mono 9 frames, stereo 3
    frames x 2 eyes."""
    out = {}
    for base, n in ((0.0, N_CAMS), (q.BOX_BASELINE, 3)):
        kw = dict(h=H, w=W, n_cams=n, noise_t=q.BOX_NOISE if base else
                  q.BOX_NOISE_T, stereo_baseline=base)
        out[base] = (jq.qf.build_scene_info(np.random.default_rng(7), **kw),
                     q.build_scene_info(np.random.default_rng(7), **kw))
    return out


@pytest.mark.parametrize("baseline", [0.0, q.BOX_BASELINE],
                         ids=["mono", "stereo"])
def test_build_scene_info_matches_jax(scenes, baseline):
    (ji, jtrue, jnoisy), (ti, ttrue, tnoisy) = scenes[baseline]
    for f in ("points", "colors"):
        np.testing.assert_array_equal(getattr(ti.point_cloud, f),
                                      getattr(ji.point_cloud, f), err_msg=f)
    for f in ("points", "colors", "instances", "timestamps"):
        np.testing.assert_array_equal(getattr(ti.dyn_point_cloud, f),
                                      getattr(ji.dyn_point_cloud, f),
                                      err_msg=f)
    assert sorted(ttrue) == sorted(jtrue) == sorted(tnoisy)
    for f in jtrue:
        np.testing.assert_array_equal(ttrue[f], jtrue[f])
        np.testing.assert_array_equal(tnoisy[f], jnoisy[f])
    for split in ("train_bboxes", "test_bboxes"):
        a, b = getattr(ti, split), getattr(ji, split)
        assert {f: list(d) for f, d in a.items()} == \
            {f: list(d) for f, d in b.items()}, split
        for f in a:
            for i in a[f]:
                np.testing.assert_array_equal(a[f][i], b[f][i].box2world)
    assert ti.instances_info == ji.instances_info
    np.testing.assert_array_equal(ti.nerf_normalization["translate"],
                                  ji.nerf_normalization["translate"])
    assert ti.nerf_normalization["radius"] == ji.nerf_normalization["radius"]
    for split in ("train_cameras", "test_cameras"):
        tc, jc = getattr(ti, split), getattr(ji, split)
        assert [c.image_name for c in tc] == [c.image_name for c in jc]
        for a, b in zip(tc, jc):
            for f in ("R", "T", "K"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert (a.FovX, a.FovY, a.frame, a.width, a.height) == \
                (b.FovX, b.FovY, b.frame, b.width, b.height)
            np.testing.assert_allclose(a.image, b.image, atol=IMG_ATOL, rtol=0)
            np.testing.assert_allclose(a.normal, b.normal, atol=IMG_ATOL,
                                       rtol=0)
    if baseline:
        # stereo: both eyes of every frame, the first eye of frames 0 and 4
        # would be held out (idx % 8): here frame 0's
        assert [c.image_name for c in ti.test_cameras] == ["street_000_0"]


def test_make_aug_cameras_matches_jax(jq, scenes):
    from vegs_torch.scene.dataset_readers import camera_from_info
    from vegs_tpu.scene.dataset_readers import camera_from_info as jcam

    (ji, _, _), (ti, _, _) = scenes[0.0]
    jaug = jq.qf4.make_aug_cameras([jcam(c) for c in ji.test_cameras])
    taug = q.make_aug_cameras([camera_from_info(c) for c in ti.test_cameras],
                              N_CAMS)
    assert len(taug) == len(jaug) == 2 * len(ti.test_cameras)
    for a, b in zip(taug, jaug):
        assert (a.image_name, a.frame, a.colmap_id) == \
            (b.image_name, b.frame, b.colmap_id)
        for f in ("R", "T", "K"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_allclose(a.image, np.asarray(b.image),
                                   atol=IMG_ATOL, rtol=0)


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["model"].pop("model_path")
    return d


@pytest.fixture
def no_diffusion(monkeypatch):
    """quality_full.py's Trainer without the tiny SD stack's Flax init (a
    minute on the CPU; the box run drops the guidance it builds)."""
    from vegs_tpu.diffusion import pipeline
    from vegs_tpu.losses import sd_guidance

    monkeypatch.setattr(pipeline.DiffusionModels, "tiny",
                        staticmethod(lambda *a, **k: None))
    monkeypatch.setattr(sd_guidance, "SDGuidance", lambda *a, **k: None)


@pytest.mark.parametrize("arm", "ABCDE")
def test_arm_config_matches_jax(jq, scenes, arm, monkeypatch):
    from vegs_tpu.train import Trainer as JTrainer

    # the config is what is compared: no state (the perceptual arm would
    # build VGG16 with JAX), and so no normal init
    monkeypatch.setattr(JTrainer, "__post_init__", lambda self: None)
    (ji, _, _), _ = scenes[0.0]
    boxes, _, lam, perceptual = q.ARMS[arm]
    jt = jq.qf5.build_trainer(ji if boxes else jq.qf5.strip_boxes(ji),
                              norminit=False, lam_dnormal=lam,
                              perceptual=perceptual, tag=arm)
    assert _cfg_dict(q.arm_config(arm, jq.qf5.ITERS)) == _cfg_dict(jt.cfg)
    assert jt.raster_cfg.k_cap == q.FULL_K_CAP
    assert jt.rng_seed == q.TRAIN_SEED
    assert (jq.qf5.H, jq.qf5.W, jq.qf5.N_CAMS) == (q.H, q.W, q.N_CAMS)
    assert (jq.qf5.ITERS, jq.qf5.EVAL_EVERY) == (q.ITERS, q.EVAL_EVERY)
    assert jq.qf5.PRETRAIN_STEPS == q.PRETRAIN_STEPS


def test_static_and_box_configs_match_jax(jq, scenes, no_diffusion):
    st = jq.r02.build_trainer()
    assert _cfg_dict(q.static_config()) == _cfg_dict(st.cfg)
    assert st.raster_cfg.k_cap == q.STATIC_K_CAP and st.rng_seed == q.TRAIN_SEED
    assert (jq.r02.H, jq.r02.W) == q.STATIC_HW
    assert (jq.r02.ITERS, jq.r02.EVAL_EVERY) == (q.STATIC_ITERS, q.STATIC_EVERY)
    (ji, _, _), _ = scenes[q.BOX_BASELINE]
    bt = jq.qf.build_trainer(ji)
    # quality_box_r05.py:50-54's changes to that Trainer
    bt.cfg.sd.perceptual_loss = False
    bt.cfg.box.boxmodel_lambda_reg = q.BOX_LAMBDA_REG
    assert _cfg_dict(q.box_config()) == _cfg_dict(bt.cfg)
    assert bt.raster_cfg.k_cap == q.BOX_K_CAP and bt.rng_seed == q.TRAIN_SEED


def test_box_pose_errors_match_jax(jq, scenes):
    from vegs_tpu.boxmodel import BoxDeltas as JDeltas

    (ji, jtrue, _), (ti, ttrue, _) = scenes[0.0]
    rng = np.random.default_rng(5)
    jd, td = {}, {}
    for f, boxes in ti.train_bboxes.items():
        for inst in boxes:
            r = np.r_[1.0, rng.normal(0, 0.05, 3)].astype(np.float32)
            s = rng.uniform(0.9, 1.1, 3).astype(np.float32)
            t = rng.normal(0, 0.1, 3).astype(np.float32)
            jd[(f, inst)] = JDeltas(jnp.asarray(r), jnp.asarray(s),
                                    jnp.asarray(t))
            td[(f, inst)] = tbox.BoxDeltas(*(torch.from_numpy(x)
                                             for x in (r, s, t)))

    def tr(info, deltas):
        return types.SimpleNamespace(
            scene=types.SimpleNamespace(train_bboxes=info.train_bboxes),
            frame_deltas=deltas)

    got = q.box_pose_errors(tr(ti, td), ttrue)
    want = jq.qf.box_pose_errors(tr(ji, jd), jtrue)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[0] != got[1]
    # without deltas the adjusted error is the raw one
    raw = q.box_pose_errors(tr(ti, {}), ttrue)
    assert raw[0] == raw[1] == got[1]


@pytest.mark.parametrize("arm", "AD")
def test_arm_ten_iterations_match_jax(jq, scenes, arm):
    (ji, _, _), (ti, _, _) = scenes[0.0]
    boxes, norminit, lam, perceptual = q.ARMS[arm]
    jt = jq.qf5.build_trainer(ji if boxes else jq.qf5.strip_boxes(ji),
                              norminit=norminit, lam_dnormal=lam,
                              perceptual=perceptual, tag=arm)
    tt = q.arm_trainer(arm, ti, device="cpu")
    for t in (jt, tt):
        t.raster_cfg = t.raster_cfg._replace(k_cap=K_CAP)
    for it in range(1, 11):
        jm = jt.train_iteration(it)
        tm = tt.train_iteration(it)
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3,
                                   err_msg=f"it {it}")
        assert tm["num_dropped"] == jm["num_dropped"] == 0
    je = jt.evaluate(with_boxes=True)
    te = tt.evaluate(with_boxes=True)
    print(f"arm {arm}: port {te}, JAX {je}")
    assert abs(te["psnr"] - je["psnr"]) <= 0.01
    assert int(tt.state.field.num_active()) == int(jt.state.field.num_active())
    assert tt.raster_cfg.k_cap == jt.raster_cfg.k_cap


def _state(tr):
    """Every tensor of a Trainer's state that the next steps read, as
    numpy, and its host-side state."""
    from vegs_torch.convert import FIELD_KEYS

    out = {}

    def put(name, x):
        if isinstance(x, torch.Tensor):
            out[name] = x.detach().numpy().copy()
        elif isinstance(x, dict):
            for k, v in x.items():
                put(f"{name}/{k}", v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                put(f"{name}/{f.name}", getattr(x, f.name))
        elif hasattr(x, "valid"):  # a GaussianField
            for k in FIELD_KEYS:
                put(f"{name}/{k}", getattr(x, k))
        else:
            out[name] = x

    put("state", tr.state)
    for k in ("box_fields", "box_opts", "box_stats", "frame_deltas",
              "frame_delta_opts"):
        put(k, getattr(tr, k))
    out["rng"] = tr.rng.bit_generator.state
    out["generator"] = tr.generator.get_state().numpy()
    out["stack"] = [c.image_name for c in tr.viewpoint_stack]
    out["raster"] = tuple(tr.raster_cfg)
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_snapshot_restore_reproduces_the_branch(scenes):
    _, (ti, _, _) = scenes[0.0]
    tr = q.arm_trainer("D", ti, device="cpu")
    tr.cfg.opt.densify_from_iter = 2
    tr.cfg.opt.densification_interval = 5   # a densify at iteration 5
    tr.cfg.opt.densify_grad_threshold = 1e-6
    for it in (1, 2, 3):
        tr.train_iteration(it)
    snap = q.snapshot_trainer(tr)
    at_snap = _state(tr)

    def branch():
        losses = [tr.train_iteration(it)["loss"] for it in (4, 5, 6)]
        return losses, _state(tr)

    l1, s1 = branch()
    assert int(tr.state.field.num_active()) > int(
        at_snap["state/field/valid"].sum()), "no densify in the branch"
    assert not np.array_equal(s1["state/field/means"][:len(
        at_snap["state/field/means"])], at_snap["state/field/means"])
    q.restore_trainer(tr, snap)
    _assert_same(_state(tr), at_snap)
    assert tr.scene.gaussians is tr.state.field
    l2, s2 = branch()
    assert l1 == l2
    _assert_same(s1, s2)
