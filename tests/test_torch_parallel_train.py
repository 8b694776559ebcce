"""The port's data-parallel training (the `comm=` path of
vegs_torch.train.train_step, the port's one data-parallel step, and
Trainer(dp_devices=2)) against vegs_tpu's on a 2-device mesh of
tests/conftest.py's virtual CPU devices. The port runs 2 gloo ranks in one
spawn (bodies: tests/torch_parallel_workers.py `dp_steps`).

  * the static step, `train_step(comm=)` (one camera a rank, f32 aux,
    normal loss on), against JAX's `make_dp_train_step`: loss rtol 1e-5,
    Adam's first moments (0.1 x the averaged gradient) within 5e-4 of each
    leaf's max |mu| + 1e-10 (float32 sums in another order; the sharded
    steps read up to 1.2e-4; an isotropic Gaussian's rotation gradient is
    zero up to ~1e-9 of noise), parameters within 1e-5 + 2e-4 |x| (the
    first Adam step is ~lr sign(g): near-zero gradients can flip, bounded
    by 2 lr of the leaf on at most 1% of entries), densify counts and
    radii exact, norm sums rtol 1e-4.
  * the full step with 2 box slots, box 1 in rank 0's frame only (it then
    averages over 1 rank, box 0 over 2; vegs_tpu/train.py:300-305),
    against `make_train_step(mesh=)`: the same bounds on the static and box
    leaves, and each active (rank, slot) residual within 1e-6 + 1e-4 |x|.
  * `Trainer(dp_devices=2)` on the toy scene of tests/test_torch_train.py,
    4 iterations (two cameras each, drawn from the same host rng) with a
    clone-only densify event at iteration 4 (threshold in the widest gap
    of the JAX run's average gradients), against the JAX Trainer: losses
    rtol 1e-4, every field entry within 1e-4 (as test_torch_train.py) but
    at most 0.1% of a leaf, which Adam moved on float32-noise gradients,
    each within 2 lr a step of its leaf (read: 2 of 16,384 quaternion
    entries, 1.4e-4), the same capacity, active count and validity.
  * an explicit camera at D = 2 against the port's single-device step on
    the same state: the field and Adam state equal to the bit (the mean of
    two equal gradients is the gradient), the densify sums and counts
    twice the single step's.
  * the replicated field and Adam state after the last step: the same
    checksum on every rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vegs_tpu import gaussians as jgauss, optim as joptim
from vegs_tpu.boxmodel import BoxDeltas as JDeltas
from vegs_tpu.config import OptimizationParams as JOpt, VegsConfig as JConfig
from vegs_tpu.gaussians import DensifyStats as JStats
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.parallel import make_dp_train_step as jdp_step, make_mesh
from vegs_tpu.parallel.sharded_step import stack_camera_batch
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.train import (BoxSlotState, TrainState as JState,
                            Trainer as JTrainer, _stack_fields, eval_render,
                            make_train_step)

from utils import make_camera
import torch_parallel_workers as workers
from test_torch_parallel import cam_numpy

from vegs_torch import convert
from vegs_torch.config import VegsConfig as TConfig
from vegs_torch.optim import field_lrs
from vegs_torch.parallel import launch

H, W, K_CAP = 48, 96, 1 << 13
D, S = 2, 2


def _cams():
    out = []
    for i in range(D):
        th = np.pi / 7 * i
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        out.append(make_camera(height=H, width=W, R=R, t=np.array([0, 0, 4.0])))
    return out


def _field(seed, n=300, cap=512):
    prng = np.random.default_rng(seed)
    return jgauss.create_from_points(
        prng.normal(size=(n, 3)).astype(np.float32),
        prng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap)


def _fnp(f):
    return {k: np.asarray(getattr(f, k)) for k in convert.FIELD_KEYS}


def _targets(seed):
    prng = np.random.default_rng(seed)
    gt = prng.uniform(0, 1, (D, 3, H, W)).astype(np.float32)
    nm = prng.normal(size=(D, 3, H, W)).astype(np.float32)
    return gt, nm / np.linalg.norm(nm, axis=1, keepdims=True)


def _schedule(cfg):
    cfg.opt.densify_from_iter = 3
    cfg.opt.densification_interval = 4
    cfg.opt.densify_until_iter = 100
    cfg.opt.opacity_reset_interval = 10_000
    cfg.opt.percent_dense = 1.0
    return cfg


def _jax_state_numpy(state):
    return {
        "field": _fnp(state.field),
        "opt": {**{m: {k: np.asarray(getattr(getattr(state.opt, m), k))
                       for k in convert.PARAM_LEAVES} for m in ("mu", "nu")},
                "count": int(state.opt.count)},
        "stats": {k: np.asarray(getattr(state.stats, k))
                  for k in convert.STATS_KEYS},
        "step": int(state.step),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cams = _cams()
    batch = stack_camera_batch(cams)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    opt_cfg = JOpt()
    raster = JRaster(backend="dense", k_cap=K_CAP, payload_dtype="f32")
    jax_out = {}

    # (a) the static DP step
    field = _field(11)
    gt, nm = _targets(12)
    step = jdp_step(make_mesh(D), opt_cfg, raster, spatial_scale=4.0,
                    height=H, width=W, use_normal_loss=True)
    f2, o2, s2, _, m = step(field, joptim.adam_init(field),
                            JStats.zeros(field.capacity), jnp.int32(0),
                            batch, jnp.asarray(gt), jnp.asarray(nm),
                            jnp.int32(3), jnp.asarray(bg))
    jax_out["dp"] = {"field": f2, "opt": o2, "stats": s2, "loss": float(m["loss"])}
    inp = {"dp": {"field": _fnp(field), "cams": [cam_numpy(c) for c in cams],
                  "gt": gt, "normal": nm, "bg": bg, "k_cap": K_CAP, "h": H,
                  "w": W}}

    # (b) the full step with 2 box slots, box 1 in rank 0's frame only
    field = _field(13)
    gt, nm = _targets(14)
    prng = np.random.default_rng(15)
    bfields = [jgauss.create_from_points(
        prng.uniform(-0.45, 0.45, (48, 3)).astype(np.float32), capacity=64)
        for _ in range(S)]
    # boxes 2.5 units wide in front of the field, so that their Gaussians
    # cover pixels and their gradients are not float32 noise
    b2w = np.tile(np.eye(4, dtype=np.float32), (D, S, 1, 1))
    b2w[:, :, :3, :3] *= 2.5
    b2w[:, 0, :3, 3] = [0.5, 0.0, -1.0]
    b2w[:, 1, :3, 3] = [-0.6, 0.2, -1.5]
    b2w[1, 0, 0, 3] = 0.55                     # each frame its own pose
    active = np.array([[True, True], [True, False]])
    nvalid = np.array([1.0, 0.0], np.float32)
    cfg = JConfig()
    jstep = make_train_step(
        opt_cfg, raster, 4.0, use_normal_loss=True, n_box_slots=S,
        box_lr_mult=cfg.opt.box_lr_mult, boxmodel_lr=cfg.box.boxmodel_lr,
        boxmodel_lambda_reg=cfg.box.boxmodel_lambda_reg, mesh=make_mesh(D))
    stack = lambda *x: jnp.stack(x)
    box_state = BoxSlotState(
        fields=_stack_fields(bfields, 64),
        opt=jax.tree.map(stack, *[joptim.adam_init(f) for f in bfields]),
        stats=jax.tree.map(stack, *[JStats.zeros(64) for _ in range(S)]))
    ident = JDeltas.identity()
    dl = jax.tree.map(lambda x: jnp.tile(x, (D, S) + (1,) * x.ndim), ident)
    dopt = jax.tree.map(stack, *[jax.tree.map(stack, *[
        joptim.tensor_adam_init(dict(delta_r=ident.delta_r,
                                     delta_s=ident.delta_s,
                                     delta_t=ident.delta_t))
        for _ in range(S)]) for _ in range(D)])
    st0 = JState(field=field, opt=joptim.adam_init(field),
                 stats=JStats.zeros(field.capacity), step=jnp.int32(0))
    st, bst, dl2, _, m = jstep(
        st0, box_state, dl, dopt, jnp.asarray(b2w), jnp.asarray(active),
        batch, jnp.asarray(gt), jnp.asarray(nm), jnp.asarray(nvalid),
        jnp.int32(3), jnp.asarray(bg), None)
    jax_out["box"] = {"state": st, "boxes": bst, "deltas": dl2,
                      "metrics": {k: float(v) for k, v in m.items()}}
    inp["box"] = {"field": _fnp(field), "box_fields": [_fnp(f) for f in bfields],
                  "b2w": b2w, "active": active, "normal_valid": nvalid,
                  "cams": [cam_numpy(c) for c in cams], "gt": gt, "normal": nm,
                  "bg": bg, "k_cap": K_CAP}

    # (c) the Trainer, 4 iterations with a densify event at the 4th
    jcfg = _schedule(JConfig())
    jraster = JRaster(backend="dense", k_cap=K_CAP)
    js = JScene(jcfg.model, scene_info=workers.scene_info(jreaders),
                shuffle=False)
    jt = JTrainer(jcfg, js, raster_cfg=jraster, dp_devices=D)
    for cam in js.train_cameras + js.test_cameras:
        cam.image = np.clip(np.asarray(eval_render(
            jt.state.field, cam.device_params(), jt.bg, 3, jraster).rgb), 0, 1)
    f = jt.state.field
    jt.state = jt.state.replace(field=f.replace(sh_dc=f.sh_dc + 0.35))
    state0 = _jax_state_numpy(jt.state)
    jl = []
    for it in range(1, 5):
        if it == 4:  # the densify event: the threshold in a wide gap
            st_ = jt.state.stats
            avg = (np.asarray(st_.xyz_gradient_accum)
                   / np.maximum(np.asarray(st_.denom), 1.0))
            v = np.sort(avg[np.asarray(jt.state.field.valid) & (avg > 0)])
            lo, hi = int(0.3 * len(v)), int(0.7 * len(v))
            i = lo + int(np.argmax(v[lo + 1:hi] / v[lo:hi - 1]))
            assert v[i + 1] / v[i] > 1.01
            thr = float(np.sqrt(v[i] * v[i + 1]))
            jcfg.opt.densify_grad_threshold = thr
        jl.append(jt.train_iteration(it)["loss"])
    jax_out["trainer"] = {"losses": jl, "state": _jax_state_numpy(jt.state)}
    inp["trainer"] = {
        "cfg": dataclasses.asdict(_schedule(JConfig())), "state": state0,
        "images": [c.image for c in js.train_cameras + js.test_cameras],
        "threshold": thr, "k_cap": K_CAP}

    torch.save(inp, tmp / "in.pt")
    port = launch.spawn(workers.dp_steps, D, str(tmp / "in.pt"),
                        backend="gloo", init_file=tmp / "rendezvous",
                        threads=2)
    return port, jax_out


def _adam_close(got, want, name, lr_bound=None):
    """Parameters after one Adam step: tight on >= 99% of entries, every
    entry within two steps of the leaf's rate (sign flips of near-zero
    gradients)."""
    diff = np.abs(got - want)
    tight = diff <= 1e-5 + 2e-4 * np.abs(want)
    assert tight.mean() >= 0.99, f"{name}: {tight.mean():.4f} tight"
    if lr_bound is not None:
        assert diff.max() <= lr_bound, f"{name}: {diff.max()}"


def _mu_close(got, want, name):
    scale = max(np.abs(want).max(), 1e-30)
    # + 1e-10: the rotations of isotropic Gaussians have an analytically
    # zero gradient, float32 noise of ~1e-9
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * scale + 1e-10,
                               err_msg=name)


def _check_field_step(got_field, got_opt, want_field, want_opt, what,
                      lr_bound):
    for k in convert.PARAM_LEAVES:
        _mu_close(got_opt["mu"][k], np.asarray(getattr(want_opt.mu, k)),
                  f"{what} mu.{k}")
        _adam_close(got_field[k], np.asarray(getattr(want_field, k)),
                    f"{what} {k}", lr_bound)


def _check_stats(got, want, what):
    np.testing.assert_array_equal(got["denom"], np.asarray(want.denom),
                                  err_msg=what)
    np.testing.assert_array_equal(got["max_radii2d"],
                                  np.asarray(want.max_radii2d), err_msg=what)
    np.testing.assert_allclose(got["xyz_gradient_accum"],
                               np.asarray(want.xyz_gradient_accum),
                               rtol=1e-4, atol=1e-7, err_msg=what)


def test_dp_step_matches_jax(runs):
    port, jx = runs
    j = jx["dp"]
    for o in port:
        got = o["dp"]
        np.testing.assert_allclose(got["loss"], j["loss"], rtol=1e-5)
        assert got["step"] == 1
        _check_field_step(got["field"], got["opt"], j["field"], j["opt"],
                          "static", 2 * 0.0025 * 4.0)
        _check_stats(got["stats"], j["stats"], "static stats")
        assert got["stats"]["denom"].max() == 2.0  # seen from both cameras


def test_dp_box_step_matches_jax(runs):
    port, jx = runs
    j = jx["box"]
    for r, o in enumerate(port):
        got = o["box"]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   j["metrics"]["loss"], rtol=1e-5)
        _check_field_step(got["field"], got["opt"], j["state"].field,
                          j["state"].opt, "static", 2 * 0.0025 * 4.0)
        _check_stats(got["stats"], j["state"].stats, "static stats")
        for i, b in enumerate(got["boxes"]):
            bf = jax.tree.map(lambda x: x[i], j["boxes"].fields)
            bo = jax.tree.map(lambda x: x[i], j["boxes"].opt)
            bs = jax.tree.map(lambda x: x[i], j["boxes"].stats)
            _check_field_step(b["field"], b["opt"], bf, bo, f"box {i}", None)
            _check_stats(b["stats"], bs, f"box {i} stats")
            if (r, i) != (1, 1):  # active on this rank: its own residual
                for k, v in b["deltas"].items():
                    np.testing.assert_allclose(
                        v, np.asarray(getattr(j["deltas"], k))[r, i],
                        rtol=1e-4, atol=1e-6, err_msg=f"rank {r} box {i} {k}")
    # box 1 was only in rank 0's frame; rank 1 left its residual alone
    np.testing.assert_array_equal(port[1]["box"]["boxes"][1]["deltas"]["delta_t"],
                                  np.zeros(3, np.float32))


def test_dp_trainer_matches_jax_over_four_steps_with_a_densify_event(runs):
    port, jx = runs
    j = jx["trainer"]
    for o in port:
        got = o["trainer"]
        np.testing.assert_allclose(got["losses"], j["losses"], rtol=1e-4)
        st = got["state"]
        assert st["step"] == j["state"]["step"] == 4
        lrs = dict(zip(convert.PARAM_LEAVES, field_lrs(
            TConfig().opt, float(o["trainer"]["extent"]), 0)))
        for k in convert.FIELD_KEYS:
            a, b = st["field"][k], j["state"]["field"][k]
            assert a.shape == b.shape, k
            if k == "valid":
                np.testing.assert_array_equal(a, b)
                continue
            # Adam moves an entry whose gradient is float32 noise by up to
            # ~lr a step in a random direction: every entry within 1e-4 but
            # at most 0.1% of a leaf, those within 2 lr a step
            diff = np.abs(a - b)
            assert (diff > 1e-4).mean() <= 1e-3, (k, (diff > 1e-4).mean())
            assert diff.max() <= 2 * 4 * float(lrs[k]), (k, diff.max())
        n_active = int(st["field"]["valid"].sum())
        assert n_active == int(j["state"]["field"]["valid"].sum()) > 150


def test_explicit_camera_matches_the_single_device_step(runs):
    port, _ = runs
    for o in port:
        dp, one = o["explicit"]["dp"], o["explicit"]["single"]
        assert o["explicit"]["loss"][0] == o["explicit"]["loss"][1]
        for k in convert.FIELD_KEYS:
            np.testing.assert_array_equal(dp["field"][k], one["field"][k], k)
        for m in ("mu", "nu"):
            for k in convert.PARAM_LEAVES:
                np.testing.assert_array_equal(dp["opt"][m][k],
                                              one["opt"][m][k])
        for k in ("xyz_gradient_accum", "denom"):
            np.testing.assert_array_equal(dp["stats"][k],
                                          2 * one["stats"][k])
        np.testing.assert_array_equal(dp["stats"]["max_radii2d"],
                                      one["stats"]["max_radii2d"])


def test_replicated_state_is_the_same_on_every_rank(runs):
    port, _ = runs
    for o in port:
        for part in ("dp", "trainer"):
            sums = o[part]["checksums"]
            assert (sums == sums[0]).all(), part
    np.testing.assert_array_equal(port[0]["dp"]["checksums"],
                                  port[1]["dp"]["checksums"])
