"""Trainer checkpoints of the port (`Trainer.save_checkpoint`,
`load_checkpoint`, `restore`, `convert.checkpoint_from_numpy`) on the toy
scene of tests/test_training.py:19-45 (150 points, 5 train + 1 test
random cameras at 48x64, all in frame 0) with one box instance (48 points
around (0, 0, 0.5)).

  * The port of tests/test_training.py:135 (`test_checkpoint_roundtrip`):
    two steps (one on a camera that sees the box), a checkpoint at 2, a
    fresh Trainer resumes it with every leaf equal to the bit (field, Adam
    moments and counts, stats, step; the box's field, Adam state and
    stats; the (frame, instance) residual and its Adam state), and trains
    on. The file is `model_path/checkpoints/2/checkpoint.pt`, and its tree
    has the JAX Trainer's keys and leaf names.
  * The JAX Trainer's tree (`_checkpoint_tree()`, and the same tree saved
    by orbax and restored as plain dicts) converts to the port's
    (`checkpoint_from_numpy`) with every leaf equal to the bit. From that
    restored state one more step on the same camera in both packages (the
    JAX Trainer on the dense backend, the port on its tile path: the plain
    versions of K1-K4) gives the same loss (rtol 1e-5) and the same state
    within the tolerances of tests/test_torch_dynamic_train.py for a step
    past Adam's first: every parameter and moment within 1e-5 (float32
    sums in another order), the step and the Adam counts equal; the box
    field's parameters, whose Adam steps on gradients within float32 noise
    of zero may go either way, within 1e-5 + 0.06 lr, and at most 2% of a
    leaf's components up to 2 lr further (the rule of
    tests/test_torch_dynamic_train.py; measured: 16 of 16,384 quaternion
    components, 1.28 lr).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vegs_tpu.config import VegsConfig as JConfig
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.train import Trainer as JTrainer, eval_render
from vegs_torch import convert, optim
from vegs_torch.config import VegsConfig
from vegs_torch.ops.rasterize import RasterizeConfig
from vegs_torch.scene import Scene, dataset_readers as treaders
from vegs_torch.train import CHECKPOINT_FILE, Trainer

K_CAP = 1 << 13
INST = 26001


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Box:
    def __init__(self, m):
        self.box2world = m


def _scene_info(readers, seed=0):
    """tests/test_training.py's `_toy_scene_info(with_box=True)`."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(150, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.2, 0.8, (150, 3)).astype(np.float32)
    cams = readers.generateRandomCameras(6, camera_distance=4.0, width=64,
                                         height=48)
    info = readers.SceneInfo(
        point_cloud=readers.BasicPointCloud(pts, cols),
        train_cameras=cams[:-1], test_cameras=cams[-1:],
        nerf_normalization=readers.getNerfppNorm(cams,
                                                 readers.BasicPointCloud(
                                                     pts, cols)),
        ply_path="")
    b2w = np.eye(4)
    b2w[:3, 3] = [0.0, 0.0, 0.5]
    dyn = rng.uniform(-0.45, 0.45, (48, 3)).astype(np.float32)
    info.dyn_point_cloud = readers.DynamicPointCloud(
        points=dyn + b2w[:3, 3], colors=np.full((48, 3), 0.6, np.float32),
        instances=np.full(48, INST), timestamps=np.zeros(48, int))
    info.train_bboxes = {0: {INST: Box(b2w)}}
    info.instances_info = [INST]
    return info


def _schedule(cfg, model_path=""):
    cfg.model.model_path = str(model_path)
    cfg.opt.densify_from_iter = 4
    cfg.opt.densification_interval = 8
    cfg.opt.densify_until_iter = 100
    cfg.opt.opacity_reset_interval = 10_000
    return cfg


def _gt_images():
    """Ground truth as tests/test_training.py makes it: the JAX initial
    field's renders (dense backend)."""
    js = JScene(JConfig().model, scene_info=_scene_info(jreaders),
                shuffle=False)
    jt = JTrainer(_schedule(JConfig()), js,
                  raster_cfg=JRaster(backend="dense", k_cap=K_CAP))
    return [np.clip(np.asarray(eval_render(jt.state.field, c.device_params(),
                                           jt.bg, 3, jt.raster_cfg).rgb), 0, 1)
            for c in js.train_cameras + js.test_cameras]


@pytest.fixture(scope="module")
def gt():
    return _gt_images()


def _port_trainer(cfg, gt):
    scene = Scene(cfg.model, scene_info=_scene_info(treaders), shuffle=False,
                  device="cpu")
    for cam, img in zip(scene.train_cameras + scene.test_cameras, gt):
        cam.image = img
    return Trainer(cfg, scene, raster_cfg=RasterizeConfig(k_cap=K_CAP),
                   device="cpu")


def _leaves(tree, prefix=()):
    """{key path: leaf} of a nested dict (records as dicts)."""
    tree = convert._as_dict(tree) if not isinstance(tree, dict) else tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or dataclasses.is_dataclass(v):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _same_bits(a, b, msg):
    a = np.asarray(a.detach().cpu() if torch.is_tensor(a) else a)
    b = np.asarray(b.detach().cpu() if torch.is_tensor(b) else b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _assert_trainer_equals_tree(tr, tree):
    """Every leaf of the Trainer's state equals the tree's (the moments'
    `valid` aside), to the bit."""
    have = _leaves(tr._checkpoint_tree())
    want = _leaves(tree)
    assert set(have) == set(want)
    for path, leaf in want.items():
        if path[-1] == "valid" and path[-2] in ("mu", "nu"):
            continue
        _same_bits(have[path], leaf, "/".join(path))


def test_checkpoint_roundtrip(tmp_path, gt, jax_trainer):
    cfg = _schedule(VegsConfig(), tmp_path / "model")
    tr = _port_trainer(cfg, gt)
    tr.train_iteration(1, camera=tr.scene.train_cameras[0])
    tr.train_iteration(2)
    tr.save_checkpoint(2)
    path = tmp_path / "model" / "checkpoints" / "2" / CHECKPOINT_FILE
    assert path.exists() and tr.checkpoint_path(2) == path
    saved = torch.load(path, map_location="cpu", weights_only=True)

    tr2 = _port_trainer(cfg, gt)
    tr2.load_checkpoint(2)
    assert tr2.state.step == tr.state.step == 2
    assert tr2.scene.gaussians is tr2.state.field
    assert (0, INST) in tr2.frame_deltas
    _assert_trainer_equals_tree(tr2, saved)
    _assert_trainer_equals_tree(tr, saved)
    m = tr2.train_iteration(3)
    assert np.isfinite(m["loss"]) and tr2.state.step == 3

    # the JAX Trainer's tree (after the same two steps) has the same keys
    # and leaf names
    assert set(_leaves(jax_trainer._checkpoint_tree())) == set(_leaves(saved))


@pytest.fixture(scope="module")
def jax_trainer(gt, tmp_path_factory):
    """The JAX Trainer after two steps, its checkpoint saved by orbax."""
    mp = tmp_path_factory.mktemp("jax_ckpt") / "model"
    jcfg = _schedule(JConfig(), mp)
    js = JScene(jcfg.model, scene_info=_scene_info(jreaders), shuffle=False)
    jt = JTrainer(jcfg, js, raster_cfg=JRaster(backend="dense", k_cap=K_CAP))
    for c, img in zip(js.train_cameras + js.test_cameras, gt):
        c.image = img
    jt.train_iteration(1, camera=js.train_cameras[0])
    jt.train_iteration(2, camera=js.train_cameras[3])
    jt.save_checkpoint(2)
    return jt


def test_jax_checkpoint_converts_and_steps_like_jax(jax_trainer, gt):
    import orbax.checkpoint as ocp

    jt = jax_trainer
    tree = jt._checkpoint_tree()
    ckpt = convert.checkpoint_from_numpy(tree, device="cpu")
    raw = ocp.StandardCheckpointer().restore(
        jt.cfg.model.model_path + "/checkpoints/2")
    ckpt_raw = convert.checkpoint_from_numpy(raw, device="cpu")

    tcfg = convert.config_from_dict(dataclasses.asdict(jt.cfg))
    tcfg.model.model_path = ""
    tt = _port_trainer(tcfg, gt)
    tt.restore(ckpt)
    assert tt.state.step == int(jt.state.step) == 2
    _assert_trainer_equals_tree(tt, tree)
    tt2 = _port_trainer(tcfg, gt)
    tt2.restore(ckpt_raw)
    _assert_trainer_equals_tree(tt2, tree)

    cam = 1
    jm = jt.train_iteration(3, camera=jt.scene.train_cameras[cam])
    tm = tt.train_iteration(3, camera=tt.scene.train_cameras[cam])
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    want = _leaves(jt._checkpoint_tree())
    have = _leaves(tt._checkpoint_tree())
    assert set(have) == set(want)
    box_lrs = optim.field_lrs(tt.cfg.opt, 1.0, 2,
                              xyz_lr_mult=tt.cfg.opt.box_lr_mult)._asdict()
    for path, leaf in want.items():
        if path[-1] == "valid" and path[-2] in ("mu", "nu"):
            continue
        got = have[path].numpy()
        leaf = np.asarray(leaf)
        if path[-1] in ("count", "step", "valid"):
            np.testing.assert_array_equal(got, leaf, err_msg="/".join(path))
        elif path[0] == "boxes" and path[2] == "field":
            lr = box_lrs[path[-1]]
            d = np.abs(got - leaf).reshape(-1)
            tol = 1e-5 + 0.06 * lr
            assert (d > tol).sum() <= 0.02 * d.size, (path, d.max())
            assert (d <= 2 * lr + tol).all(), (path, d.max())
        else:
            np.testing.assert_allclose(got, leaf, rtol=0, atol=1e-5,
                                       err_msg="/".join(path))
    assert int(tt.state.opt["count"]) == 3
    # the step moved the restored state
    assert not torch.equal(tt.state.field.sh_dc,
                           ckpt_raw["state"].field.sh_dc)
    assert optim.PARAM_LEAVES == convert.FIELD_KEYS[:-1]
