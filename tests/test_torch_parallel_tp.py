"""The port's fully sharded trainer (vegs_torch.parallel.tp_trainer)
against vegs_tpu/parallel/tp_trainer.py: the port runs gloo ranks (one
spawn at D = 2 for the TP step, the densify and the TP-full step; one at
D = 4 for the 2 x 2 hybrid; bodies in tests/torch_parallel_workers.py),
the JAX side a mesh of the same shape on the virtual CPU devices. The
inputs are tests/test_parallel.py's (48x96, 300 points in 512 rows, f32
aux), the port's row blocks put back together in rank order.

Tolerances (those of tests/test_parallel.py:356-377 for the sharded JAX
step against its single-device step):
  * losses rtol 1e-5;
  * Adam's first moments (0.1 x the gradient) within 5e-4 of each leaf's
    max |mu| + 1e-10 (read: 1.2e-4 on one entry of the TP step's means;
    the rotations of these isotropic Gaussians have a zero gradient up to
    float32 noise of ~1e-9); the parameters within 1e-5 + 2e-4 |x| on >= 99% of each
    leaf's entries (a first Adam step is ~lr sign(g), so a float32-noise
    gradient can flip) and within 2 lr everywhere; densify counts and
    radii exact, norm sums rtol 1e-4 and atol the larger of 1e-7 (1e-6 for
    the hybrid) and 5e-4 of the largest sum (read: 3.1e-7, 3.9e-4 of it);
  * the TP-full step's box leaves as the JAX test bounds them against its
    single-device step: >= 95% of entries tight and every entry within one
    flipped Adam step of its leaf; residuals rtol 1e-4 atol 1e-6;
  * `tp_densify_and_prune`: the same active count and per-shard capacity
    as JAX's, every kept or cloned row present (split children are random
    draws: only their number is compared);
  * the hybrid's data rows hold the same blocks, to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vegs_tpu import densify as jdensify, gaussians as jgauss, optim as joptim
from vegs_tpu.boxmodel import BoxDeltas as JDeltas
from vegs_tpu.config import OptimizationParams as JOpt, VegsConfig as JConfig
from vegs_tpu.gaussians import DensifyStats as JStats
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.parallel.sharded_step import stack_camera_batch
from vegs_tpu.parallel.tile_sharded import make_tile_mesh
from vegs_tpu.parallel.tp_trainer import (
    make_dp_mesh_2d, make_dp_tp_train_step, make_tp_full_train_step,
    make_tp_train_step, shard_train_state, tp_densify_and_prune)

from utils import make_camera
import torch_parallel_workers as workers
from test_torch_parallel import cam_numpy
from test_torch_parallel_train import _adam_close, _fnp, _mu_close

from vegs_torch import convert
from vegs_torch.parallel import launch

H, W, K_CAP = 48, 96, 1 << 13
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
DENSIFY_KW = dict(grad_threshold=2e-4, percent_dense=0.01, extent=4.0,
                  min_opacity=0.005, max_screen_size=0)
LR_BOUND = {"means": 2 * 0.00016 * 4.0, "quats": 2e-3, "log_scales": 1e-2,
            "sh_dc": 5e-3, "sh_rest": 5e-3 / 20, "opacity_logit": 0.1}


def _field(seed, n=300, cap=512):
    prng = np.random.default_rng(seed)
    return jgauss.create_from_points(
        prng.normal(size=(n, 3)).astype(np.float32),
        prng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap)


def _targets(seed, lead=()):
    prng = np.random.default_rng(seed)
    gt = prng.uniform(0, 1, lead + (3, H, W)).astype(np.float32)
    nm = prng.normal(size=lead + (3, H, W)).astype(np.float32)
    return gt, nm / np.linalg.norm(nm, axis=-3, keepdims=True)


def _spawn(tmp, fn, world, inp):
    torch.save(inp, tmp / "in.pt")
    return launch.spawn(fn, world, str(tmp / "in.pt"), backend="gloo",
                        init_file=tmp / "rendezvous", threads=1)


def _raster():
    return JRaster(backend="dense", k_cap=K_CAP, payload_dtype="f32")


def _box_inputs(S=2, bcap=64):
    prng = np.random.default_rng(19)
    bfields = [jgauss.create_from_points(
        prng.uniform(-0.45, 0.45, (48, 3)).astype(np.float32), capacity=bcap)
        for _ in range(S)]
    b2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    b2w[:, :3, :3] *= 2.5
    b2w[0, :3, 3] = [0.5, 0.0, -1.0]
    b2w[1, :3, 3] = [-0.6, 0.2, -1.5]
    return bfields, b2w, np.array([True, True])


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """D = 2: the TP step, the densify, the TP-full step."""
    cam = make_camera(height=H, width=W, t=np.array([0, 0, 4.0]))
    gt, nm = _targets(8)
    opt_cfg = JOpt()
    mesh = make_tile_mesh(2)
    jx = {}
    field = _field(7)
    sf, so, ss = shard_train_state(mesh, field, joptim.adam_init(field),
                                   JStats.zeros(field.capacity))
    step = make_tp_train_step(mesh, opt_cfg, _raster(), spatial_scale=4.0,
                              cam=cam, use_normal_loss=True)
    nf, no, ns, _, met = step(sf, so, ss, jnp.int32(0), cam, jnp.asarray(gt),
                              jnp.asarray(nm), jnp.int32(3), jnp.asarray(BG))
    jx["tp"] = (nf, no, ns, {k: float(v) for k, v in met.items()})
    inp = {"tp": {"field": _fnp(field), "cam": cam_numpy(cam), "gt": gt,
                  "normal": nm, "bg": BG, "k_cap": K_CAP}}

    # the densify: tests/test_parallel.py:437's fabricated statistics
    prng = np.random.default_rng(3)
    dfield = jgauss.create_from_points(
        prng.normal(size=(400, 3)).astype(np.float32),
        prng.uniform(0, 1, (400, 3)).astype(np.float32), capacity=512)
    accum = prng.uniform(0, 4e-4, 512).astype(np.float32)
    stats = JStats(max_radii2d=jnp.zeros(512), xyz_gradient_accum=accum,
                   denom=jnp.ones(512))
    clone, split, prune = (np.asarray(x) for x in jdensify.densify_masks(
        dfield, stats, 2e-4, 0.01, 4.0, 0.005, 0))
    keep = np.asarray(dfield.valid) & ~prune & ~split
    means = np.asarray(dfield.means)
    want_rows = np.concatenate([means[keep], means[clone]])
    d_np = _fnp(dfield)
    sf, so, ss = shard_train_state(mesh, dfield, joptim.adam_init(dfield),
                                   stats)
    jf, _, _, jn = tp_densify_and_prune(mesh, sf, so, ss, jax.random.key(5),
                                        **DENSIFY_KW)
    jx["densify"] = (jn, int(jf.capacity), want_rows, int(split.sum()))
    inp["densify"] = {"field": d_np, "kw": DENSIFY_KW,
                      "stats": {"max_radii2d": np.zeros(512, np.float32),
                                "xyz_gradient_accum": accum,
                                "denom": np.ones(512, np.float32)}}

    # the TP-full step with 2 box slots
    field = _field(13)
    bfields, b2w, active = _box_inputs()
    S = len(bfields)
    cfg = JConfig()
    stack = lambda *x: jnp.stack(x)
    bst = jax.tree.map(stack, *bfields)
    bopt = jax.tree.map(stack, *[joptim.adam_init(f) for f in bfields])
    bstats = jax.tree.map(stack, *[JStats.zeros(64) for _ in range(S)])
    ident = JDeltas.identity()
    deltas = jax.tree.map(lambda x: jnp.tile(x, (S,) + (1,) * x.ndim), ident)
    dopt = joptim.tensor_adam_init(dict(delta_r=deltas.delta_r,
                                        delta_s=deltas.delta_s,
                                        delta_t=deltas.delta_t))
    sf, so, ss = shard_train_state(mesh, field, joptim.adam_init(field),
                                   JStats.zeros(field.capacity))
    bsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None,
                                                                      "shard"))
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    put_b = lambda t: jax.tree.map(
        lambda x: jax.device_put(x, bsh if x.ndim >= 2 else rep), t)
    full = make_tp_full_train_step(
        mesh, opt_cfg, _raster(), spatial_scale=4.0, cam=cam,
        use_normal_loss=True, n_box_slots=S, box_lr_mult=cfg.opt.box_lr_mult,
        boxmodel_lr=cfg.box.boxmodel_lr,
        boxmodel_lambda_reg=cfg.box.boxmodel_lambda_reg)
    res = full(sf, so, ss, jnp.int32(0), put_b(bst), put_b(bopt),
               put_b(bstats), deltas, dopt, jnp.asarray(b2w),
               jnp.asarray(active), cam, jnp.asarray(gt), jnp.asarray(nm),
               jnp.float32(1.0), jnp.int32(3), jnp.asarray(BG))
    jx["full"] = res
    inp["full"] = {"field": _fnp(field), "box_fields": [_fnp(f) for f in bfields],
                   "b2w": b2w, "active": active}
    port = _spawn(tmp_path_factory.mktemp("tp"), workers.tp_steps, 2, inp)
    return port, jx


def _check_step(blocks, part, jf, jo, js, accum_atol=1e-7, bound=True):
    for k in convert.PARAM_LEAVES:
        _mu_close(np.concatenate([b[part]["opt"]["mu"][k] for b in blocks]),
                  np.asarray(getattr(jo.mu, k)), f"mu.{k}")
        _adam_close(np.concatenate([b[part]["field"][k] for b in blocks]),
                    np.asarray(getattr(jf, k)), k,
                    LR_BOUND[k] if bound else None)
    st = {k: np.concatenate([b[part]["stats"][k] for b in blocks])
          for k in convert.STATS_KEYS}
    np.testing.assert_array_equal(st["denom"], np.asarray(js.denom))
    np.testing.assert_array_equal(st["max_radii2d"], np.asarray(js.max_radii2d))
    want = np.asarray(js.xyz_gradient_accum)
    np.testing.assert_allclose(st["xyz_gradient_accum"], want, rtol=1e-4,
                               atol=max(accum_atol, 5e-4 * want.max()))


def test_tp_step_matches_jax(tp):
    port, jx = tp
    jf, jo, js, jm = jx["tp"]
    for o in port:
        np.testing.assert_allclose(o["tp"]["metrics"]["loss"], jm["loss"],
                                   rtol=1e-5)
        assert o["tp"]["metrics"]["num_dropped"] == jm["num_dropped"] == 0
        assert o["tp"]["metrics"]["num_needed"] == jm["num_needed"]
        assert o["tp"]["metrics"]["num_needed_exch"] == jm["num_needed_exch"]
    _check_step(port, "tp", jf, jo, js)


def test_tp_densify_matches_jax_decisions_and_counts(tp):
    port, jx = tp
    jn, jcap, want_rows, n_split = jx["densify"]
    assert all(o["densify"]["n"] == jn for o in port)
    assert sum(o["densify"]["capacity"] for o in port) == jcap
    assert jcap % 2 == 0 and port[0]["densify"]["capacity"] % 512 == 0
    got = np.concatenate([o["densify"]["means"][o["densify"]["valid"]]
                          for o in port])
    assert len(got) == jn == len(want_rows) + 2 * n_split
    got_set = {tuple(np.round(r, 5)) for r in got}
    missing = [r for r in want_rows if tuple(np.round(r, 5)) not in got_set]
    assert not missing, f"{len(missing)} kept/cloned rows missing"


def test_tp_full_step_with_boxes_matches_jax(tp):
    port, jx = tp
    nf, no, ns, _, nbf, nbo, nbs, ndl, _, met = jx["full"]
    for o in port:
        np.testing.assert_allclose(o["full"]["metrics"]["loss"],
                                   float(met["loss"]), rtol=1e-5)
        assert o["full"]["metrics"]["num_dropped"] == 0
        for k, v in o["full"]["deltas"].items():
            np.testing.assert_allclose(v, np.asarray(getattr(ndl, k)),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    # the residuals are replicated: the same bits on both ranks
    for k in port[0]["full"]["deltas"]:
        np.testing.assert_array_equal(port[0]["full"]["deltas"][k],
                                      port[1]["full"]["deltas"][k])
    _check_step(port, "full", nf, no, ns)
    flip_bound = {"means": 2e-3, "quats": 2.2e-3, "log_scales": 1.1e-2,
                  "sh_dc": 5.5e-3, "sh_rest": 5.5e-3 / 20,
                  "opacity_logit": 0.11}
    for i in range(2):
        for k in convert.PARAM_LEAVES:
            a = np.concatenate([o["full"]["boxes"][i]["field"][k]
                                for o in port])
            b = np.asarray(getattr(nbf, k))[i]
            diff = np.abs(a - b)
            assert (diff <= 1e-5 + 2e-4 * np.abs(b)).mean() >= 0.95, (i, k)
            assert diff.max() <= flip_bound[k], (i, k, diff.max())
        st = {k: np.concatenate([o["full"]["boxes"][i]["stats"][k]
                                 for o in port]) for k in convert.STATS_KEYS}
        np.testing.assert_array_equal(st["denom"], np.asarray(nbs.denom)[i])
        np.testing.assert_allclose(st["xyz_gradient_accum"],
                                   np.asarray(nbs.xyz_gradient_accum)[i],
                                   rtol=1e-4, atol=1e-6)


def test_dp_tp_hybrid_step_matches_jax(tmp_path):
    cams = []
    for i in range(2):
        th = np.pi / 7 * i
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        cams.append(make_camera(height=H, width=W, R=R,
                                t=np.array([0, 0, 4.0])))
    gt, nm = _targets(11, (2,))
    field = _field(11)
    mesh = make_dp_mesh_2d(2, 2)
    sf, so, ss = shard_train_state(mesh, field, joptim.adam_init(field),
                                   JStats.zeros(field.capacity))
    hyb = make_dp_tp_train_step(mesh, JOpt(), _raster(), spatial_scale=4.0,
                                cam=cams[0])
    jf, jo, js, _, jm = hyb(sf, so, ss, jnp.int32(0), stack_camera_batch(cams),
                            jnp.asarray(gt), jnp.asarray(nm), jnp.int32(3),
                            jnp.asarray(BG))
    port = _spawn(tmp_path, workers.dptp_step, 4,
                  {"field": _fnp(field), "cams": [cam_numpy(c) for c in cams],
                   "gt": gt, "normal": nm, "bg": BG, "k_cap": K_CAP})
    assert [(o["data"], o["shard"]) for o in port] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    for o in port:
        np.testing.assert_allclose(o["metrics"]["loss"], float(jm["loss"]),
                                   rtol=1e-5)
    for k in convert.PARAM_LEAVES:  # the data rows agree to the bit
        for a, b in ((0, 2), (1, 3)):
            np.testing.assert_array_equal(port[a]["field"][k],
                                          port[b]["field"][k])
    rows = [{"h": o} for o in port[:2]]
    _check_step(rows, "h", jf, jo, js, accum_atol=1e-6)


def test_tp_full_step_with_guidance_and_perceptual_matches_one_device(
        tmp_path):
    """The TP-full step's guidance (SDS with the tiny diffusion stack,
    draws fixed) and perceptual terms (VGG16, random features) through the
    tile-sharded augmented render, against the port's single-device step
    with the same terms (itself held against the JAX step in
    tests/test_torch_guided_train.py): losses rtol 1e-5, Adam's first
    moments within 5e-4 of each leaf's max + 1e-10, the residual within
    1e-6 + 1e-4 |x|."""
    cam = make_camera(height=H, width=W, t=np.array([0, 0, 4.0]))
    aug = make_camera(height=32, width=64, t=np.array([0.2, 0, 4.0]))
    gt, nm = _targets(21)
    bfields, b2w, _ = _box_inputs()
    port = _spawn(tmp_path, workers.tp_full_extras, 2, {
        "field": _fnp(_field(23)), "box_field": _fnp(bfields[0]),
        "b2w": b2w[0], "cam": cam_numpy(cam), "aug_cam": cam_numpy(aug),
        "crop_start": 9, "gt": gt, "normal": nm, "bg": BG, "k_cap": K_CAP})
    for o in port:
        for k in ("loss", "guidance_loss", "perceptual_loss"):
            np.testing.assert_allclose(o["tp_metrics"][k], o["one_metrics"][k],
                                       rtol=1e-5, err_msg=k)
        for k in convert.PARAM_LEAVES:
            _mu_close(o["tp_mu"][k], o["one_mu"][k], f"mu.{k}")
        for k, v in o["tp_deltas"].items():
            np.testing.assert_allclose(v, o["one_deltas"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert o["tp_metrics"]["guidance_loss"] != 0.0
