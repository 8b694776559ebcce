"""The port's TP quality harness (vegs_torch/perf/quality_tp.py) against the
JAX package's (perf/quality_tp.py, quality_tp_full.py, quality_tp_r05.py,
quality_tp_r05b_adapter.py).

The JAX scripts are not imported: on import they set XLA_FLAGS and clear
JAX's backends if they are up (quality_tp_full.py:31-42), which would clear
this worker's. The JAX side is rebuilt here from `vegs_tpu` in the scripts'
order, with the lines cited.

  * The 32x64 mover scene (quality_tp_full.py:61-86) and the 48x96 r02
    scene (quality_tp.py:60-84) from the same numpy seed: points, colours,
    capacities, images, camera-space normal maps, true and noisy box poses
    equal to the bit (the same numpy code); the seeded fields within 1e-6
    (scales and SH from the same numbers through each package's ops), the
    world normals within 1e-6.
  * `evaluate` on a fixed field and seeded residuals (the box grown 1.5-2.5
    times so it covers pixels of the held-out views) against JAX's
    `make_eval` (dense backend) within 1e-4 dB, at k_cap 8192 instead of
    the runs' 2^14 (JAX's dense spec is O(k_cap x pixels); the views need
    ~2.5k slots, so nothing is dropped at either).
  * The port's `AdapterLog` and `KCapAdapter` against JAX's `KCapAdapter`
    and r05b's loop, fed one scripted (dropped, needed) stream: the same
    events, r05b's recorded ones.
  * The single-device and TP loops (TP at D = 2: gloo ranks on the CPU,
    JAX's mesh on 2 virtual CPU devices) for 5 steps at k_cap 4096 (no
    instance dropped: a render does not depend on k_cap then, and JAX's
    dense TP step at 8192 takes ~10 s here): a densify event moved to step
    3 (the threshold picked in a wide gap of the statistics, the split
    draws JAX's, replayed) and at the same step one forced adapter
    rebuild (a stale cap of 6144, a new tile plan). The TP mask report at
    the event: JAX's `densify_masks` counts on its gathered state, and 0
    rows differing between the port's global and shard-local masks.
    Tolerances: tests/test_torch_parallel_tp.py's bounds are for one step;
    here Adam's sign flips compound over five. The field starts
    isotropic, so the rotations' first gradient is float32 noise and
    their first step is +-lr in either package; the split children's
    means are the parents' plus the parents' rotation of a draw of up to
    ~0.4, so they differ by up to ~5e-3 (read 4.7e-3). Hence: losses rtol
    1e-5 up to the densify event, 1e-4 after it (read 1.8e-5); every
    parameter within 2 lr a step of JAX's (the children's means within
    1e-2), tight (1e-5 + 2e-4 |x|) on >= 95% of each leaf outside the
    children (read >= 96.7%); Adam's first moments within 5e-4 of the
    leaf's max |mu| on >= 95% (read >= 97.6%) and within 2e-2 of it
    everywhere (read 1.4e-2); the rotations held by the 2 lr a step bound
    and their moments within 1e-5; box fields as the field, residuals
    rtol 1e-4 atol 1e-6 (read 8e-10 to 1.2e-7) and equal on both ranks.
  * `held`: a record outside the band fails, one inside passes; the
    adapter's order checks; the harness raises without a card unless
    asked for the CPU, and a failing rank fails the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from test_torch_parallel_train import _fnp

from vegs_torch import convert
from vegs_torch.boxmodel import BoxDeltas as TDeltas
from vegs_torch.parallel.tp_trainer import KCapAdapter as TAdapter
from vegs_torch.perf import quality_tp as q

STEPS, DENSIFY_IT, REBUILD_IT, REBUILD_K = 5, 3, 3, 6144
LOOP_K_CAP = 4096
# each leaf's Adam rate (the means' at the spatial scale; the box fields'
# at scale 1 times box_lr_mult)
LR = {"means": 0.00016 * q.SPATIAL, "quats": 1e-3, "log_scales": 5e-3,
      "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20, "opacity_logit": 0.05}
BOX_LR = dict(LR, means=0.00016 * q.BOX_LR_MULT)
PARAM_TIGHT, MU_TIGHT, MU_ALL, ROT_MU = 0.95, 0.95, 2e-2, 1e-5
# losses: rtol 1e-5 to the densify event, LATE_RTOL after it (the split
# children carry the rotations' noise, below)
LATE_RTOL = 1e-4
# a split child's mean is its parent's plus the parent's rotation of a
# draw of up to ~3 scales (~0.4 here): the rotations Adam moved on noise
# (above) move the children by ~1e-3 of that offset
CHILD_MEANS = 1e-2


def _children(valid, masks, caps):
    """The rows of the split children after each of len(caps) row blocks
    recompacts itself with these (clone, split, prune) masks: a block writes
    [kept | clones | split children x2] from its first row, into caps[i]
    rows."""
    n = len(caps)
    clone, split, prune = (np.asarray(m).reshape(n, -1) for m in masks)
    keep = np.asarray(valid).reshape(n, -1) & ~prune & ~split
    out = []
    for i, cap in enumerate(caps):
        rows = np.zeros(cap, bool)
        start = int(keep[i].sum() + clone[i].sum())
        rows[start:start + 2 * int(split[i].sum())] = True
        out.append(rows)
    return np.concatenate(out)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- the JAX side, in the scripts' order --------------------------------------


def jax_scene(rng, h=q.H, w=q.W, n_cams=q.N_CAMS):
    """quality_tp_full.py:61-86 (build_scene); also returns the sampled
    points and colours."""
    from vegs_tpu import gaussians
    from vegs_tpu.scene.dataset_readers import camera_from_info
    from vegs_tpu.utils import synthetic as syn

    infos = syn.street_camera_infos(n_cams, h, w, moving_box=True,
                                    render_normal=True)
    cams = [camera_from_info(ci) for ci in infos]
    train_cams = [c for i, c in enumerate(cams) if i % 8 != 0]
    test_cams = [c for i, c in enumerate(cams) if i % 8 == 0]
    pts, cols = syn.sample_scene_points(rng, n_ground=400, n_box=100,
                                        n_sky=600)
    field = gaussians.create_from_points(
        pts, cols, capacity=gaussians.round_capacity(pts.shape[0], 512))
    canon, ccols = syn.mover_canonical_points(rng, n=96)
    bfield = gaussians.create_from_points(canon, ccols, capacity=128)
    true_b2w, noisy_b2w = {}, {}
    for f in range(n_cams):
        m = syn.mover_box2world(f, n_cams)
        true_b2w[f] = m
        noise = np.eye(4, dtype=np.float32)
        noise[:3, 3] = rng.normal(0, q.BOX_NOISE_T, 3).astype(np.float32)
        noisy_b2w[f] = (noise @ m).astype(np.float32)
    return dict(field=field, bfield=bfield, train_cams=train_cams,
                test_cams=test_cams, true_b2w=true_b2w, noisy_b2w=noisy_b2w,
                pts=pts, cols=cols, canon=canon, ccols=ccols)


def jax_static_scene(rng):
    """quality_tp.py:60-84."""
    from vegs_tpu import gaussians
    from vegs_tpu.scene.dataset_readers import camera_from_info
    from vegs_tpu.utils import synthetic as syn

    infos = syn.street_camera_infos(q.N_CAMS, *q.STATIC_HW)
    cams = [camera_from_info(ci) for ci in infos]
    pts, cols = syn.sample_scene_points(rng, n_ground=700, n_box=150,
                                        n_sky=1500)
    field = gaussians.create_from_points(
        pts, cols, capacity=gaussians.round_capacity(pts.shape[0], 512))
    return dict(field=field, train_cams=[c for i, c in enumerate(cams)
                                         if i % 8 != 0],
                test_cams=[c for i, c in enumerate(cams) if i % 8 == 0],
                pts=pts, cols=cols)


def jax_evaluate(js, field, bfield, deltas_map, k_cap=q.EVAL_K_CAP):
    """quality_tp_full.py:89-110 (make_eval's evaluate), dense backend."""
    from vegs_tpu.boxmodel import BoxDeltas, adjust_box2world
    from vegs_tpu.losses import psnr
    from vegs_tpu.ops.rasterize import RasterizeConfig
    from vegs_tpu.render import (_concat_arrays, _run, field_arrays,
                                 transform_field_arrays)

    cfg = RasterizeConfig(backend="dense", k_cap=k_cap)
    vals = []
    for c in js["test_cams"]:
        f = int(c.frame)
        d = deltas_map.get(f, (BoxDeltas.identity(), None))[0]
        b2w = adjust_box2world(jnp.asarray(js["noisy_b2w"][f]), d)
        parts = [field_arrays(field, 3),
                 transform_field_arrays(field_arrays(bfield, 3), b2w)]
        out = _run(c.device_params(), _concat_arrays(parts), bg=jnp.zeros(3),
                   scale_modifier=1.0, override_color=None, sh_degree=3,
                   config=cfg, means2d_offset=None)
        vals.append(float(psnr(jnp.clip(out.rgb, 0, 1),
                               jnp.asarray(c.original_image))))
    return float(np.mean(vals))


@pytest.fixture(scope="module")
def scenes():
    return (jax_scene(np.random.default_rng(q.SCENE_SEED)),
            q.build_scene(np.random.default_rng(q.SCENE_SEED), device="cpu"))


def _same_cameras(jcams, tcams):
    assert [c.image_name for c in jcams] == [c.image_name for c in tcams]
    for j, t in zip(jcams, tcams):
        assert int(j.frame) == int(t.frame)
        np.testing.assert_array_equal(np.asarray(t.original_image),
                                      np.asarray(j.original_image))
        for k in ("R", "T", "K"):
            np.testing.assert_array_equal(np.asarray(getattr(t, k)),
                                          np.asarray(getattr(j, k)))
        jn, tn = j.original_normal, t.original_normal
        assert (jn is None) == (tn is None)
        if jn is not None:
            np.testing.assert_array_equal(np.asarray(tn), np.asarray(jn))
            np.testing.assert_allclose(t.world_normal(),
                                       np.asarray(j.world_normal()),
                                       rtol=0, atol=1e-6)


def _same_field(tfield, jfield, pts, cols=None):
    assert tfield.capacity == jfield.capacity
    got = convert.field_to_numpy(tfield)
    n = len(pts)
    np.testing.assert_array_equal(got["means"][:n], pts)
    np.testing.assert_array_equal(got["valid"], np.asarray(jfield.valid))
    for k in convert.FIELD_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jfield, k)),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_mover_scene_matches_jax(scenes):
    js, ts = scenes
    # the points and colours of the draw, to the bit: the port's draws in
    # the same order from the same seed
    from vegs_torch.utils import synthetic as tsyn

    rng = np.random.default_rng(q.SCENE_SEED)
    pts, cols = tsyn.sample_scene_points(rng, n_ground=400, n_box=100,
                                         n_sky=600)
    canon, ccols = tsyn.mover_canonical_points(rng, n=96)
    for a, b in ((pts, js["pts"]), (cols, js["cols"]), (canon, js["canon"]),
                 (ccols, js["ccols"])):
        np.testing.assert_array_equal(a, b)
    _same_field(ts.field, js["field"], js["pts"])
    _same_field(ts.bfield, js["bfield"], js["canon"])
    assert ts.field.capacity == 1536 and ts.bfield.capacity == 128
    _same_cameras(js["train_cams"], ts.train_cams)
    _same_cameras(js["test_cams"], ts.test_cams)
    assert sorted(ts.true_b2w) == sorted(js["true_b2w"]) == list(range(9))
    for f in js["true_b2w"]:
        np.testing.assert_array_equal(ts.true_b2w[f], js["true_b2w"][f])
        np.testing.assert_array_equal(ts.noisy_b2w[f], js["noisy_b2w"][f])


def test_static_scene_matches_jax():
    js = jax_static_scene(np.random.default_rng(q.STATIC_SEED))
    ts = q.build_static_scene(np.random.default_rng(q.STATIC_SEED),
                              device="cpu")
    _same_field(ts.field, js["field"], js["pts"])
    assert int(ts.field.num_active()) == q.JAX_R02[0][1]  # 2824 in r02
    _same_cameras(js["train_cams"], ts.train_cams)
    _same_cameras(js["test_cams"], ts.test_cams)
    assert ts.bfield is None and ts.noisy_b2w == {}


def test_evaluate_matches_jax(scenes):
    from vegs_tpu.boxmodel import BoxDeltas as JDeltas

    js, ts = scenes
    prng = np.random.default_rng(3)
    jmap, tmap = {}, {}
    for c in js["test_cams"]:
        q_ = np.array([1.0, *prng.normal(0, 0.05, 3)], np.float32)
        d = dict(delta_r=q_ / np.linalg.norm(q_),
                 delta_s=prng.uniform(1.5, 2.5, 3).astype(np.float32),
                 delta_t=prng.normal(0, 0.3, 3).astype(np.float32))
        jmap[int(c.frame)] = (JDeltas(**{k: jnp.asarray(v)
                                         for k, v in d.items()}),)
        tmap[int(c.frame)] = TDeltas(**{k: torch.from_numpy(v)
                                        for k, v in d.items()})
    # a fixed field: the seeded one with its colours moved
    f = js["field"]
    jf = f.replace(sh_dc=f.sh_dc + 0.2)
    tf = convert.field_from_numpy(_fnp(jf), device="cpu")
    bf = convert.field_from_numpy(_fnp(js["bfield"]), device="cpu")
    want = jax_evaluate(js, jf, js["bfield"], jmap, k_cap=LOOP_K_CAP)
    got = q.evaluate(ts, tf, bf, tmap, k_cap=LOOP_K_CAP)
    assert abs(got - want) <= 1e-4, (got, want)
    # the residuals matter: identity residuals read another PSNR
    assert abs(q.evaluate(ts, tf, bf, {}, k_cap=LOOP_K_CAP) - got) > 1e-3


def test_adapter_events_match_jax():
    """r05b's loop (quality_tp_r05b_adapter.py:123-145) on a scripted
    stream: two dropping steps at a ~3.5k-instance need, then steady."""
    from vegs_tpu.parallel.tp_trainer import KCapAdapter as JAdapter

    stream = [(1.0 if it <= 2 else 0.0, 3500.0) for it in range(1, 241)]
    ja = JAdapter(1024, k_cap_min=512, decay_window=25)
    jev = []
    for it, (dropped, needed) in enumerate(stream, start=1):
        if it == 120:
            ja.k_cap = 32768
            ja._low_streak = 0
            jev.append((it, "stale-resume", 32768))
        new = ja.update(dropped, needed)
        if new is not None:
            jev.append((it, "grow" if dropped > 0 else "decay", new))
    log = q.AdapterLog(TAdapter(1024, k_cap_min=512, decay_window=25),
                       swap=q.R05B_SWAP)
    rebuilt = [it for it, (d, n) in enumerate(stream, start=1)
               if log.observe(it, d, n) is not None]
    assert log.events == jev == q.JAX_R05B
    assert rebuilt == [it for it, _, _ in q.JAX_R05B]
    assert q.adapter_order_ok(log.events, [d for d, _ in stream]) == (True,
                                                                      True)


# -- 5 steps of both loops against JAX ------------------------------------------


def _threshold_in_gap(stats, valid):
    avg = (np.asarray(stats.xyz_gradient_accum)
           / np.maximum(np.asarray(stats.denom), 1.0))
    v = np.sort(avg[np.asarray(valid) & (avg > 0)])
    lo, hi = int(0.5 * len(v)), int(0.9 * len(v))
    i = lo + int(np.argmax(v[lo + 1:hi] / v[lo:hi - 1]))
    assert v[i + 1] / v[i] > 1.01
    return float(np.sqrt(v[i] * v[i + 1]))


def _gap_holds(stats, valid, thr):
    avg = (np.asarray(stats.xyz_gradient_accum)
           / np.maximum(np.asarray(stats.denom), 1.0))[np.asarray(valid)]
    return np.abs(avg / thr - 1).min() > 1e-3


@pytest.fixture(scope="module")
def loops(scenes, tmp_path_factory):
    """JAX's single-device loop (quality_tp_r05.py:129-158) and TP loop
    (:160-240) at D = 2 for STEPS steps, the densify at DENSIFY_IT, the
    TP step rebuilt at REBUILD_K after REBUILD_IT; then the port's."""
    from vegs_tpu import densify, optim
    from vegs_tpu.boxmodel import BoxDeltas
    from vegs_tpu.gaussians import DensifyStats
    from vegs_tpu.ops.rasterize import RasterizeConfig
    from vegs_tpu.parallel.tile_sharded import make_tile_mesh
    from vegs_tpu.parallel.tp_trainer import (make_tp_full_train_step,
                                              shard_train_state,
                                              tp_densify_and_prune)
    from vegs_tpu.train import BoxSlotState, TrainState, make_train_step

    js, ts = scenes
    field, bfield = js["field"], js["bfield"]
    opt_cfg = q.opt_config()
    raster = RasterizeConfig(backend="dense", k_cap=LOOP_K_CAP)
    kw = dict(use_normal_loss=True, box_lr_mult=2.0, boxmodel_lr=1e-3,
              boxmodel_lambda_reg=1e-2)
    stack1 = lambda t: jax.tree.map(lambda x: x[None], t)
    ident = BoxDeltas.identity()
    dopt0 = optim.tensor_adam_init(dict(
        delta_r=ident.delta_r[None], delta_s=ident.delta_s[None],
        delta_t=ident.delta_t[None]))
    active = jnp.ones((1,), bool)
    cams = q.camera_order(ts, 0, STEPS)
    jcams = {c.image_name: c for c in js["train_cams"]}

    def inputs(c):
        jc = jcams[c.image_name]
        f = int(jc.frame)
        return (f, jnp.asarray(jc.original_image),
                jnp.asarray(jc.world_normal()),
                jnp.asarray(js["noisy_b2w"][f])[None], jc.device_params())

    out = {"thr": None}
    key = jax.random.key(100 + DENSIFY_IT)
    single = make_train_step(opt_cfg, raster, spatial_scale=q.SPATIAL,
                             n_box_slots=1, **kw)
    st = TrainState(field=field, opt=optim.adam_init(field),
                    stats=DensifyStats.zeros(field.capacity),
                    step=jnp.int32(0))
    bs = BoxSlotState(fields=stack1(bfield),
                      opt=stack1(optim.adam_init(bfield)),
                      stats=stack1(DensifyStats.zeros(bfield.capacity)))
    dmap = {f: (stack1(ident), dopt0) for f in range(q.N_CAMS)}
    losses = []
    for it, c in enumerate(cams, start=1):
        f, gt, normal, b2w, camp = inputs(c)
        deltas, dopt = dmap[f]
        st, bs, deltas, dopt, met = single(
            st, bs, deltas, dopt, b2w, active, camp, gt, normal,
            jnp.float32(1.0), jnp.int32(3), jnp.zeros(3))
        dmap[f] = (deltas, dopt)
        losses.append(float(met["loss"]))
        assert float(met["num_dropped"]) == 0
        if it == DENSIFY_IT:
            thr = out["thr"] = _threshold_in_gap(st.stats, st.field.valid)
            opt_cfg.densify_grad_threshold = thr
            out["single_noise"] = np.asarray(jax.random.normal(
                key, (2, st.field.capacity, 3)))
            masks = densify.densify_masks(st.field, st.stats, thr,
                                          opt_cfg.percent_dense, q.SPATIAL,
                                          0.005, 0)
            f2, o2, s2, _ = densify.densify_and_prune(
                st.field, st.opt, st.stats, key, grad_threshold=thr,
                percent_dense=opt_cfg.percent_dense, extent=q.SPATIAL)
            out["single_children"] = _children(st.field.valid, masks,
                                               [f2.capacity])
            st = TrainState(field=f2, opt=o2, stats=s2, step=st.step)
    out["single"] = dict(losses=losses, field=st.field, opt=st.opt,
                         box_field=jax.tree.map(lambda x: x[0], bs.fields),
                         deltas=dmap)

    mesh = make_tile_mesh(2)
    sf, so, ss = shard_train_state(mesh, field, optim.adam_init(field),
                                   DensifyStats.zeros(field.capacity))
    bshard = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "shard"))
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    put_b = lambda t: jax.tree.map(
        lambda x: jax.device_put(x, bshard if x.ndim >= 2 else repl), t)
    bf = put_b(stack1(bfield))
    bo = put_b(stack1(optim.adam_init(bfield)))
    bstats = put_b(stack1(DensifyStats.zeros(bfield.capacity)))
    cam0 = js["train_cams"][0].device_params()
    build = lambda r: make_tp_full_train_step(
        mesh, opt_cfg, r, spatial_scale=q.SPATIAL, cam=cam0, n_box_slots=1,
        **kw)
    tp = build(raster)
    dmap = {f: (stack1(ident), dopt0) for f in range(q.N_CAMS)}
    step = jnp.int32(0)
    losses = []
    for it, c in enumerate(cams, start=1):
        f, gt, normal, b2w, camp = inputs(c)
        deltas, dopt = dmap[f]
        (sf, so, ss, step, bf, bo, bstats, deltas, dopt, met) = tp(
            sf, so, ss, step, bf, bo, bstats, deltas, dopt, b2w, active,
            camp, gt, normal, jnp.float32(1.0), jnp.int32(3), jnp.zeros(3))
        dmap[f] = (deltas, dopt)
        losses.append(float(met["loss"]))
        assert float(met["num_dropped"]) == 0
        if it == REBUILD_IT:
            tp = build(raster._replace(k_cap=REBUILD_K))
        if it == DENSIFY_IT:
            fh, sh = jax.device_get(sf), jax.device_get(ss)
            assert _gap_holds(sh, fh.valid, thr)
            out["tp_masks"] = [np.asarray(m) for m in densify.densify_masks(
                jax.tree.map(jnp.asarray, fh), jax.tree.map(jnp.asarray, sh),
                thr, opt_cfg.percent_dense, q.SPATIAL, 0.005, 0)]
            keys = jax.random.split(key, 2)
            out["tp_noise"] = [np.asarray(jax.random.normal(
                keys[i], (2, sf.capacity // 2, 3))) for i in range(2)]
            sf, so, ss, _ = tp_densify_and_prune(
                mesh, sf, so, ss, key, grad_threshold=thr,
                percent_dense=opt_cfg.percent_dense, extent=q.SPATIAL)
            out["tp_children"] = _children(fh.valid, out["tp_masks"],
                                           [sf.capacity // 2] * 2)
    out["tp"] = dict(losses=losses, field=jax.device_get(sf),
                     opt=jax.device_get(so), capacity=sf.capacity,
                     box_field=jax.tree.map(lambda x: np.asarray(x)[0],
                                            jax.device_get(bf)),
                     deltas=dmap)

    # the port's loops on the same draws
    port = q.run_single(ts, seed=0, iters=STEPS, every=None,
                        densify=(DENSIFY_IT,) * 3, k_cap=LOOP_K_CAP,
                        grad_threshold=thr,
                        noise={DENSIFY_IT: out["single_noise"]},
                        log=lambda m: None)
    (ptp,) = q.run_tp([{
        "kind": "full", "seed": 0, "iters": STEPS, "every": None,
        "densify": (DENSIFY_IT,) * 3, "k_cap": LOOP_K_CAP, "masks": True,
        "adapter": (LOOP_K_CAP, 512, 10 ** 6), "swap": (REBUILD_IT, REBUILD_K),
        "grad_threshold": thr, "noise": {DENSIFY_IT: out["tp_noise"]}}],
        ndev=2, device="cpu", after=workers.tp_state_blocks, threads=1)
    return out, port, ptp


def _leaf_close(got, want, what, bound, tight_share, exempt=False,
                children=None):
    """Parameters after STEPS Adam steps: every entry within `bound` (two
    rates a step: each run moves an entry by at most about its rate a
    step; an array of bounds by row where split children differ); tight
    (1e-5 + 2e-4 |x|) on >= `tight_share` of the entries outside the
    `children` rows, the rotations exempt (see the module docstring)."""
    diff = np.abs(got - want)
    bound = np.broadcast_to(np.reshape(bound, (-1,) + (1,) * (diff.ndim - 1))
                            if np.ndim(bound) else bound, diff.shape)
    assert (diff <= bound).all(), f"{what}: {(diff / bound).max()} bound"
    tight = diff <= 1e-5 + 2e-4 * np.abs(want)
    tight = (tight if children is None else tight[~children]).mean()
    assert exempt or tight >= tight_share, f"{what}: {tight:.4f} tight"


def _moments_close(got, want, what, rotation=False):
    """Adam's first moments: within 5e-4 of the leaf's max |mu| + 1e-10
    on >= MU_TIGHT of the entries, every entry within MU_ALL of it; the
    rotations' (float32 noise at the start, see the module docstring)
    within ROT_MU."""
    scale = max(np.abs(want).max(), 1e-30)
    diff = np.abs(got - want)
    if rotation:
        assert diff.max() <= ROT_MU, f"{what}: {diff.max()}"
        return
    share = (diff <= 5e-4 * scale + 1e-10).mean()
    assert diff.max() <= MU_ALL * scale, f"{what}: {diff.max() / scale}"
    assert share >= MU_TIGHT, f"{what}: {share:.4f} tight"


def _check_state(got_field, got_mu, want_field, want_opt, children, what):
    for k in convert.PARAM_LEAVES:
        rot = k == "quats"
        _moments_close(got_mu[k], np.asarray(getattr(want_opt.mu, k)),
                       f"{what} mu.{k}", rotation=rot)
        bound = 2 * STEPS * LR[k]
        if k == "means":
            bound = np.where(children, CHILD_MEANS, bound)
        _leaf_close(got_field[k], np.asarray(getattr(want_field, k)),
                    f"{what} {k}", bound, PARAM_TIGHT, rot,
                    children if k == "means" else None)
    np.testing.assert_array_equal(got_field["valid"],
                                  np.asarray(want_field.valid))


def _check_box(got_bf, got_deltas, want_bf, want_deltas, what):
    for k in convert.PARAM_LEAVES:
        _leaf_close(got_bf[k], np.asarray(getattr(want_bf, k)),
                    f"{what} {k}", 2 * STEPS * BOX_LR[k], PARAM_TIGHT,
                    k == "quats")
    for f, d in got_deltas.items():
        for k, v in d.items():
            np.testing.assert_allclose(
                v, np.asarray(getattr(want_deltas[f][0], k))[0], rtol=1e-4,
                atol=1e-6, err_msg=f"{what} frame {f} {k}")


def _losses_close(got, want):
    n = DENSIFY_IT
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-5)
    np.testing.assert_allclose(got[n:], want[n:], rtol=LATE_RTOL)


def test_single_loop_matches_jax(loops):
    jx, port, _ = loops
    j = jx["single"]
    _losses_close(port["losses"], j["losses"])
    assert port["densify"] == [{"it": DENSIFY_IT,
                                "n": int(j["field"].num_active()),
                                "capacity": int(j["field"].capacity)}]
    st = port["state"]
    _check_state(convert.field_to_numpy(st.field),
                 {k: v.numpy() for k, v in st.opt["mu"].items()},
                 j["field"], j["opt"], jx["single_children"], "single")
    _check_box(convert.field_to_numpy(port["box_field"]),
               {f: {k: v.numpy() for k, v in d.as_dict().items()}
                for f, (d, _) in port["deltas"].items()},
               j["box_field"], j["deltas"], "single box")


def test_tp_loop_matches_jax(loops):
    jx, _, ptp = loops
    j = jx["tp"]
    _losses_close(ptp["losses"], j["losses"])
    blocks = [r["after"] for r in ptp["ranks"]]
    cat = lambda part, k: np.concatenate([b[part][k] for b in blocks])
    field = {k: cat("field", k) for k in convert.FIELD_KEYS}
    mu = {k: cat("mu", k) for k in convert.PARAM_LEAVES}
    assert len(field["means"]) == j["capacity"]
    assert ptp["densify"][0]["n"] == int(j["field"].num_active())
    _check_state(field, mu, j["field"], j["opt"], jx["tp_children"], "tp")
    box = {k: cat("box_field", k) for k in convert.FIELD_KEYS}
    _check_box(box, blocks[0]["deltas"], j["box_field"], j["deltas"], "tp box")
    # the residuals are replicated: the same bits on both ranks
    for f in blocks[0]["deltas"]:
        for k, v in blocks[0]["deltas"][f].items():
            np.testing.assert_array_equal(v, blocks[1]["deltas"][f][k])


def test_tp_mask_report_and_rebuild(loops):
    jx, _, ptp = loops
    (m,) = ptp["masks"]
    assert m["it"] == DENSIFY_IT
    assert m["counts"] == [int(x.sum()) for x in jx["tp_masks"]]
    assert sum(m["counts"][:2]) > 0
    assert m["diffs"] == [0, 0, 0]
    assert ptp["adapter_events"] == [(REBUILD_IT, "stale-resume", REBUILD_K)]
    assert [r["rebuilds"] for r in ptp["ranks"]] == [[REBUILD_IT]] * 2
    assert ptp["k_cap_final"] == REBUILD_K
    assert not any(ptp["dropped"])


# -- held() and the entry points ---------------------------------------------------


def _tp_rec(psnr, events=(), rebuilds=(), dropped=(0,), launches=None,
            masks=()):
    launches = launches or {"K1": 5, "K2": 5, "K3": 5, "K4": 0}
    rank = {"adapter_events": list(events), "rebuilds": list(rebuilds),
            "step_launches": launches}
    return {"final_psnr": psnr, "trend": [{"it": 150, "psnr": psnr}],
            "adapter_events": list(events), "rebuilds": list(rebuilds),
            "dropped": list(dropped), "masks": list(masks),
            "ranks": [dict(rank, rank=r) for r in range(4)],
            "box_err_raw": 0.109}


def _seeds_record(offset):
    runs = {}
    for s in range(3):
        single = {"final_psnr": q.JAX_R05["single"][s] + offset,
                  "box_err_raw": 0.1091}
        tp = _tp_rec(q.JAX_R05["tp"][s] + offset,
                     events=[(30, "decay", 16384)] if s == 0 else [],
                     rebuilds=[30] if s == 0 else [],
                     masks=[{"it": 160, "counts": [0, 341, 1],
                             "diffs": [0, 0, 0]}])
        runs[str(s)] = {"single": single, "tp": tp}
    return {"runs": runs}


def test_held_fails_outside_the_band():
    band = q.PSNR_BAND_DB
    inside = {r[0]: r[4] for r in q.held({"seeds": _seeds_record(
        0.9 * band)})}
    assert all(inside.values()), inside
    outside = {r[0]: r[4] for r in q.held({"seeds": _seeds_record(
        1.1 * band)})}
    missed = [k for k, ok in outside.items() if not ok]
    assert missed and all("final PSNR" in k for k in missed)
    full = {"single": {"final_psnr": 13.05 - 1.1 * band},
            "tp": _tp_rec(13.7)}
    rows = {r[0]: r[4] for r in q.held({"full": full})}
    assert rows == {"r04 single final PSNR": False, "r04 tp final PSNR": True,
                    "r04 TP steps launch K1-K3, no K4": True}


def test_held_adapter_order_and_launches():
    ev = [(1, "grow", 2048), (2, "grow", 4096), (120, "stale-resume", 32768),
          (144, "decay", 16384)]
    good = _tp_rec(11.0, ev, [1, 2, 120, 144], dropped=[5, 3] + [0] * 200)
    ok = {r[0].split(" (")[0]: r[4] for r in q.held({"adapter": {"tp": good}})}
    assert all(ok.values()), ok
    bad = _tp_rec(11.0, [ev[2], ev[0], ev[3]], [1, 120, 144],
                  dropped=[5, 0, 0, 1], launches={"K1": 5, "K2": 5, "K3": 5,
                                                  "K4": 1})
    bad["ranks"][2]["rebuilds"] = [1, 121, 144]
    rows = {r[0].split(" (")[0]: r[4] for r in q.held({"adapter": {"tp": bad}})}
    assert not any(rows.values()), rows


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q.run_adapter()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q.build_scene(np.random.default_rng(0))
    # a failing rank fails the run: a spec without its densify schedule
    with pytest.raises(RuntimeError, match="ranks failed"):
        q.run_tp([{"kind": "full", "seed": 0, "iters": 1, "k_cap": q.K_CAP}],
                 ndev=2, device="cpu", threads=1)
