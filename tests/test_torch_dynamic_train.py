"""The port's Trainer with dynamic boxes against the JAX Trainer, on the
toy scene of tests/test_training.py:19-45 (150 points, 5 train + 1 test
random cameras at 48x64, all in frame 0) with TWO box instances of
different capacities: 26001 seeded from 48 world points (capacity 4096),
26002 a 30-point field built at capacity 8192. The JAX Trainer pads every
box to the largest capacity while the boxes are pooled, the port keeps
each at its own, so the concatenated Gaussian index differs between the
two; the renumbering is monotone and the sorts stable, so the renders do
not. The boxes sit at yaw angles 0.3 and 1.1 rad, away from the ties of
`rotmat_to_quat`'s argmax (at 0 or pi/2 two candidates tie, and float
differences between the packages could take the gradient down another
branch).

  * Both Trainers start from the same state (converted with
    `convert.train_state_from_numpy` and `convert.box_state_from_numpy`):
    ground truth rendered with the boxes at their annotated pose, sh_dc +
    0.35 on every field, and each (frame, instance) residual's delta_t set
    0.05 off identity. Six steps on the same cameras, with one densify
    event at iteration 5 that covers the static field and both boxes and
    only clones (percent_dense = 1). The grad threshold is set before the
    event in the widest gap of the JAX run's averages, the static ones and
    twice the boxes' (boxes densify at half the threshold). The JAX
    Trainer runs the dense backend, the port its tile path on the CPU (the
    plain versions of K1-K4).
    Tolerance: losses within rtol 1e-4; every static parameter, each
    (frame, instance) residual and its moments, and the box statistics
    within 1e-4 (float32 sums in another order, amplified by six Adam
    steps); the box fields' Adam moments, which carry the gradients
    themselves, within 1e-6 (measured <= 1.2e-7). Adam's first step moves
    each component by lr * sign(g), so a box component whose first
    gradient lies within float32 noise of zero steps either way in either
    package: the box parameters are held within 1e-4 + 0.06 lr (1% of six
    steps at the leaf's rate), and at most 2% of a leaf's components may
    instead differ by up to one step more, 2 lr (measured with 2 torch
    threads: 1 of 308 quaternion components of box 26001, 2 of 164 of box
    26002, none elsewhere). The same capacities after the event, active
    counts, validity masks and Adam counts.
  * `evaluate(with_boxes=True, with_ssim=True)` against the JAX Trainer's
    on a frame whose ground truth holds the boxes (rtol 1e-4), and the
    boxes improving the PSNR, as tests/test_training.py:167 checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vegs_tpu import boxmodel as jbox, gaussians as jgauss
from vegs_tpu.config import VegsConfig as JConfig
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.render import BoxInstance as JBoxInstance, render_all as jrender_all
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.train import Trainer as JTrainer
from vegs_torch import convert, gaussians as tgauss, optim
from vegs_torch.config import ModelParams
from vegs_torch.ops.rasterize import RasterizeConfig
from vegs_torch.scene import Scene, dataset_readers as treaders
from vegs_torch.train import Trainer

K_CAP = 1 << 13
A, B = 26001, 26002  # the two instances
YAW = {A: 0.3, B: 1.1}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Box:
    def __init__(self, m):
        self.box2world = m


def _b2w(inst):
    """Box-to-world of an instance: yaw about the cameras' up axis (z), per
    axis scales, a translation near the origin."""
    c, s = np.cos(YAW[inst]), np.sin(YAW[inst])
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    S = np.diag([1.2, 0.8, 1.0]) if inst == A else np.diag([0.9, 1.1, 0.7])
    m = np.eye(4)
    m[:3, :3] = R @ S
    m[:3, 3] = [0.0, 0.0, 0.5] if inst == A else [0.5, -0.4, -0.3]
    return m


def _scene_info(readers, seed=0, n_pts=150, n_cams=6):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.2, 0.8, (n_pts, 3)).astype(np.float32)
    pcd = readers.BasicPointCloud(pts, cols)
    cams = readers.generateRandomCameras(n_cams, camera_distance=4.0,
                                         width=64, height=48)
    info = readers.SceneInfo(
        point_cloud=pcd, train_cameras=cams[:-1], test_cameras=cams[-1:],
        nerf_normalization=readers.getNerfppNorm(cams, pcd), ply_path="")
    canon = rng.uniform(-0.45, 0.45, (48, 3))
    world = (np.c_[canon, np.ones(48)] @ _b2w(A).T)[:, :3].astype(np.float32)
    info.dyn_point_cloud = readers.DynamicPointCloud(
        points=world, colors=rng.uniform(0.5, 0.9, (48, 3)).astype(np.float32),
        instances=np.full(48, A), timestamps=np.zeros(48, int))
    info.train_bboxes = {0: {A: Box(_b2w(A)), B: Box(_b2w(B))}}
    info.instances_info = [A, B]
    return info


def _box_b_points(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.45, 0.45, (30, 3)).astype(np.float32),
            rng.uniform(0.3, 0.7, (30, 3)).astype(np.float32))


def _schedule(cfg):
    cfg.opt.densify_from_iter = 4
    cfg.opt.densification_interval = 5
    cfg.opt.densify_until_iter = 100
    cfg.opt.opacity_reset_interval = 10_000
    cfg.opt.percent_dense = 1.0
    return cfg


def _np_field(f):
    return {k: np.asarray(getattr(f, k)) for k in convert.FIELD_KEYS}


def _np_adam(o):
    return {**{m: {k: np.asarray(getattr(getattr(o, m), k))
                   for k in convert.PARAM_LEAVES} for m in ("mu", "nu")},
            "count": int(o.count)}


def _jax_state_numpy(state):
    return {"field": _np_field(state.field), "opt": _np_adam(state.opt),
            "stats": {k: np.asarray(getattr(state.stats, k))
                      for k in convert.STATS_KEYS},
            "step": int(state.step)}


def _jax_box_state_numpy(jt):
    fields = jt.current_box_fields()
    return {
        "box_fields": {i: _np_field(f) for i, f in fields.items()},
        "box_opts": {i: _np_adam(o) for i, o in jt.box_opts.items()},
        "box_stats": {i: {k: np.asarray(getattr(st, k))
                          for k in convert.STATS_KEYS}
                      for i, st in jt.box_stats.items()},
        "frame_deltas": {k: {n: np.asarray(getattr(d, n))
                             for n in ("delta_r", "delta_s", "delta_t")}
                         for k, d in jt.frame_deltas.items()},
        "frame_delta_opts": {
            k: {"mu": {n: np.asarray(v) for n, v in o.mu.items()},
                "nu": {n: np.asarray(v) for n, v in o.nu.items()},
                "count": int(o.count)}
            for k, o in jt.frame_delta_opts.items()},
    }


def _trainers():
    """(JAX Trainer, port Trainer) from the same state (module docstring)."""
    jcfg = _schedule(JConfig())
    jraster = JRaster(backend="dense", k_cap=K_CAP)
    js = JScene(jcfg.model, scene_info=_scene_info(jreaders), shuffle=False)
    pts, cols = _box_b_points()
    js.box_gaussians[B] = jgauss.create_from_points(
        pts, cols, capacity=8192, scale_clip=(1e-7, 1e-4))
    jt = JTrainer(jcfg, js, raster_cfg=jraster)
    assert js.box_gaussians[A].capacity == 4096
    insts = [JBoxInstance(field=js.box_gaussians[i],
                          box2world=jnp.asarray(_b2w(i), jnp.float32))
             for i in (A, B)]
    gt = jax.jit(lambda cam: jrender_all(cam, jt.state.field, insts, bg=jt.bg,
                                         config=jraster)[0].rgb)
    for cam in js.train_cameras + js.test_cameras:
        cam.image = np.clip(np.asarray(gt(cam.device_params())), 0, 1)
    f = jt.state.field
    jt.state = jt.state.replace(field=f.replace(sh_dc=f.sh_dc + 0.35))
    rng = np.random.default_rng(2)
    for i in (A, B):
        # opaque anisotropic splats of a few pixels, at random rotations: a
        # box Gaussian as seeded (isotropic, sub-pixel, opacity 0.1) has a
        # rotation and scale gradient of rounding noise, which Adam would
        # scale up to its full rate
        bf = jt.box_fields[i]
        c = bf.capacity
        op = rng.uniform(0.2, 0.5, (c, 1))
        jt.box_fields[i] = bf.replace(
            sh_dc=bf.sh_dc + 0.35,
            quats=jnp.asarray(rng.normal(size=(c, 4)), jnp.float32),
            log_scales=jnp.asarray(np.log(rng.uniform(0.05, 0.15, (c, 3))),
                                   jnp.float32),
            opacity_logit=jnp.asarray(np.log(op / (1 - op)), jnp.float32))
        off = np.array([0.05, -0.03, 0.04]) * (1 if i == A else -1)
        jt.frame_deltas[(0, i)] = jbox.BoxDeltas.identity().replace(
            delta_t=jnp.asarray(off, jnp.float32))
        jt.frame_delta_opts[(0, i)] = __import__(
            "vegs_tpu.optim", fromlist=["x"]).tensor_adam_init(dict(
                delta_r=jnp.zeros(4).at[0].set(1.0), delta_s=jnp.ones(3),
                delta_t=jnp.zeros(3)))

    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ts = Scene(ModelParams(), scene_info=_scene_info(treaders), shuffle=False,
               device="cpu")
    ts.box_gaussians[B] = tgauss.create_from_points(
        pts, cols, capacity=8192, scale_clip=(1e-7, 1e-4), device="cpu")
    for tc, jc in zip(ts.train_cameras + ts.test_cameras,
                      js.train_cameras + js.test_cameras):
        tc.image = jc.image
    tt = Trainer(tcfg, ts, raster_cfg=RasterizeConfig(k_cap=K_CAP),
                 device="cpu")
    tt.state = convert.train_state_from_numpy(_jax_state_numpy(jt.state),
                                              device="cpu")
    ts.gaussians = tt.state.field
    for k, v in convert.box_state_from_numpy(_jax_box_state_numpy(jt),
                                             device="cpu").items():
        setattr(tt, k, v)
    assert [tt.box_fields[i].capacity for i in (A, B)] == [4096, 8192]
    return jt, tt


def _threshold(jt):
    """A grad threshold in the widest gap of the static averages and twice
    the box averages (boxes densify at half the threshold)."""
    def avg(st, valid):
        a = (np.asarray(st.xyz_gradient_accum)
             / np.maximum(np.asarray(st.denom), 1.0))
        return a[np.asarray(valid) & (a > 0)]

    v = [avg(jt.state.stats, jt.state.field.valid)]
    fields = jt.current_box_fields()
    v += [2 * avg(jt.box_stats[i], fields[i].valid) for i in (A, B)]
    v = np.sort(np.concatenate(v))
    lo, hi = int(0.3 * len(v)), int(0.7 * len(v))
    i = lo + int(np.argmax(v[lo + 1:hi] / v[lo:hi - 1]))
    assert v[i + 1] / v[i] > 1.01
    return float(np.sqrt(v[i] * v[i + 1]))


def _valid_rows(x, valid):
    return np.asarray(x)[np.asarray(valid, bool)]


def _assert_adam_close(got, want, lr, msg):
    """Box parameters after six Adam steps at rate `lr` (module docstring)."""
    d = np.abs(got - want).reshape(-1)
    tol = 1e-4 + 0.06 * lr
    flips = d > tol
    assert flips.sum() <= 0.02 * d.size, (msg, d.max(), flips.sum())
    assert (d <= 2 * lr + tol).all(), (msg, d.max())


@pytest.fixture(scope="module")
def trained():
    """Both Trainers after the six steps: (jt, tt, JAX losses, port losses,
    the port's active box rows before)."""
    jt, tt = _trainers()
    n0 = {i: int(tt.box_fields[i].num_active()) for i in (A, B)}
    jl, tl = [], []
    for it in range(1, 7):
        if it == 5:
            thr = _threshold(jt)
            jt.cfg.opt.densify_grad_threshold = thr
            tt.cfg.opt.densify_grad_threshold = thr
        jl.append(jt.train_iteration(it, camera=jt.scene.train_cameras[it % 5])["loss"])
        tl.append(tt.train_iteration(it, camera=tt.scene.train_cameras[it % 5])["loss"])
    return jt, tt, jl, tl, n0


def test_dynamic_trainer_matches_jax_over_six_steps_with_a_box_densify_event(
        trained):
    jt, tt, jl, tl, n0 = trained
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tt.state.step == int(jt.state.step) == 6
    assert tt.state.field.capacity == jt.state.field.capacity
    assert int(tt.state.field.num_active()) == int(jt.state.field.num_active())
    got = convert.field_to_numpy(tt.state.field)
    for k in convert.FIELD_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jt.state.field, k)),
                                   rtol=0, atol=1e-4, err_msg=k)

    want = _jax_box_state_numpy(jt)
    have = convert.box_state_to_numpy(tt)
    lrs = optim.field_lrs(tt.cfg.opt, 1.0, 0,
                          xyz_lr_mult=tt.cfg.opt.box_lr_mult)._asdict()
    for i in (A, B):
        jv, tv = want["box_fields"][i]["valid"], have["box_fields"][i]["valid"]
        n = int(tv.sum())
        assert n == int(jv.sum()) > n0[i], i  # the event cloned box rows
        assert tv[:n].all() and jv[:n].all()  # valid rows lead, in order
        assert tt.box_fields[i].capacity == jt.box_fields[i].capacity
        for k in convert.FIELD_KEYS[:-1]:
            _assert_adam_close(_valid_rows(have["box_fields"][i][k], tv),
                               _valid_rows(want["box_fields"][i][k], jv),
                               lrs[k], f"{i} {k}")
            for m in ("mu", "nu"):
                np.testing.assert_allclose(
                    _valid_rows(have["box_opts"][i][m][k], tv),
                    _valid_rows(want["box_opts"][i][m][k], jv), rtol=0,
                    atol=1e-6, err_msg=f"{i} {m} {k}")
        assert have["box_opts"][i]["count"] == want["box_opts"][i]["count"] == 6
        for k in convert.STATS_KEYS:
            np.testing.assert_allclose(
                _valid_rows(have["box_stats"][i][k], tv),
                _valid_rows(want["box_stats"][i][k], jv), rtol=0, atol=1e-4)
    assert set(have["frame_deltas"]) == set(want["frame_deltas"]) == {(0, A), (0, B)}
    for key, d in want["frame_deltas"].items():
        for k, v in d.items():
            np.testing.assert_allclose(have["frame_deltas"][key][k], v,
                                       rtol=0, atol=1e-4, err_msg=f"{key} {k}")
        o = want["frame_delta_opts"][key]
        for m in ("mu", "nu"):
            for k, v in o[m].items():
                np.testing.assert_allclose(have["frame_delta_opts"][key][m][k],
                                           v, rtol=0, atol=1e-4)
        assert have["frame_delta_opts"][key]["count"] == o["count"] == 6
    # the residuals moved off their start
    assert np.abs(have["frame_deltas"][(0, A)]["delta_t"]
                  - [0.05, -0.03, 0.04]).max() > 1e-3


def test_evaluate_with_boxes_and_ssim_matches_jax(trained):
    """`evaluate(with_boxes=True, with_ssim=True)` composites each frame's
    instances with their learned residuals (`render_all`): PSNR, L1 and
    SSIM against the JAX Trainer's within rtol 1e-4 on the held-out camera
    (its ground truth holds the boxes)."""
    jt, tt, *_ = trained
    got = tt.evaluate(with_boxes=True, with_ssim=True)
    want = jt.evaluate(with_boxes=True, with_ssim=True)
    for k in ("psnr", "l1", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["n_cams"] == 1 and 0.0 <= got["ssim"] <= 1.0
    assert got["psnr"] != tt.evaluate(with_boxes=False)["psnr"]


def test_evaluate_composites_the_frames_boxes():
    """The port's counterpart of tests/test_training.py:167: with the
    ground truth of a frame rendered with its boxes at their annotated pose
    (`render_all`), `evaluate(with_boxes=True)` reproduces it better than
    the static field alone."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.render import BoxInstance, render_all

    scene = Scene(ModelParams(), scene_info=_scene_info(treaders),
                  shuffle=False, device="cpu")
    raster = RasterizeConfig(k_cap=K_CAP, forward_only=True)
    tr = Trainer(VegsConfig(), scene, raster_cfg=raster, device="cpu")
    cam0 = scene.train_cameras[0]
    insts = [BoxInstance(scene.box_gaussians[i],
                         torch.from_numpy(_b2w(i).astype(np.float32)))
             for i in (A, B)]
    with torch.no_grad():
        out, _ = render_all(cam0.device_params("cpu"), tr.state.field, insts,
                            bg=tr.bg, config=raster)
    cam0.image = np.clip(out.rgb.numpy(), 0, 1)
    e_static = tr.evaluate(cameras=[cam0], with_ssim=True)
    e_boxes = tr.evaluate(cameras=[cam0], with_boxes=True, with_ssim=True)
    assert np.isfinite(e_boxes["psnr"]) and 0.0 <= e_boxes["ssim"] <= 1.0
    assert e_boxes["psnr"] > e_static["psnr"] + 1.0
