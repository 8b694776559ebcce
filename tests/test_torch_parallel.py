"""The port's collectives, launch and sharded renders (vegs_torch.parallel)
against closed forms, the port's single-device `rasterize` and
vegs_tpu/parallel.

The port runs one process per rank: `launch.spawn` starts D gloo ranks on
the CPU (bodies in tests/torch_parallel_workers.py, which imports no JAX);
the JAX side runs a mesh of the same D on the virtual CPU devices of
tests/conftest.py, in this process. Each D spawns once (a module fixture),
and the tests read its results.

Tolerances:
  * collectives: exact (small integers in float32);
  * the gauss- and tile-sharded renders at D = 2 and 4: equal to the bit
    to the port's `rasterize` on the same inputs (ties resolve to the
    ascending global index on both paths); against the JAX sharded renders
    (dense backend) within 2e-6 on rgb and alpha, 1e-5 on depth, the JAX
    test's own bounds against its single-device render
    (tests/test_parallel.py:223);
  * the tile-sharded gradient of mean(rgb^2) (divided by D: every rank
    takes the loss of the whole image) against the single-device one:
    rtol 1e-4, atol 1e-6, as tests/test_parallel.py:283 (sums in another
    order through the exchange);
  * exchange drops with k_exch = 8 (tests/test_parallel.py:288's case,
    2048 Gaussians at 48x96): the same count as JAX's;
  * D = 1: the JAX tile-sharded function raises (it never defines `me` on
    a 1-device mesh, tile_sharded.py:167-221); the port's renders equal to
    the bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vegs_tpu import gaussians as jgauss, optim as joptim
from vegs_tpu.gaussians import DensifyStats as JStats
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.parallel.gauss_sharded import (
    make_gauss_mesh as jgauss_mesh, make_gauss_sharded_rasterize as jgauss_fn,
    shard_field_arrays as jshard, sharded_state_bytes as jstate_bytes)
from vegs_tpu.parallel.tile_sharded import (
    make_tile_mesh as jtile_mesh, make_tile_sharded_rasterize as jtile_fn)
from vegs_tpu.parallel.tp_trainer import (KCapAdapter as JAdapter,
                                          shard_train_state as jshard_state)

from utils import make_camera, random_gaussians
import torch_parallel_workers as workers

from vegs_torch import convert
from vegs_torch.gaussians import create_from_points
from vegs_torch.parallel import launch
from vegs_torch.parallel.gauss_sharded import sharded_state_bytes
from vegs_torch.parallel.tp_trainer import KCapAdapter

H, W, N, K_CAP = 32, 64, 1024, 1 << 13


def cam_numpy(cam) -> dict:
    return {k: np.asarray(getattr(cam, k)) for k in
            ("viewmatrix", "projmatrix", "campos", "tan_fovx", "tan_fovy",
             "height", "width")}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cam = make_camera(height=H, width=W)
    g = random_gaussians(rng, N)
    return cam, g


def _drop_case():
    rng = np.random.default_rng(1)
    cam = make_camera(height=48, width=96)
    return cam, random_gaussians(rng, 2048)


def _spawn(tmp, fn, world, *args):
    return launch.spawn(fn, world, *args, backend="gloo",
                        init_file=tmp / "rendezvous", threads=1)


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def sharded(request, tmp_path_factory):
    D = request.param
    tmp = tmp_path_factory.mktemp(f"par{D}")
    cam, g = _inputs()
    inp = {"cam": cam_numpy(cam), "gaussians": [np.asarray(x) for x in g],
           "bg": np.asarray([0.1, 0.2, 0.3], np.float32), "k_cap": K_CAP}
    dcam, dg = _drop_case()
    inp["drop_case"] = {"cam": cam_numpy(dcam), "k_cap": 1 << 14,
                        "k_exch": 8, "gaussians": [np.asarray(x) for x in dg]}
    torch.save(inp, tmp / "in.pt")
    coll = _spawn(tmp_path_factory.mktemp(f"coll{D}"), workers.collectives,
                  D)
    res = _spawn(tmp_path_factory.mktemp(f"rend{D}"), workers.renders, D,
                 str(tmp / "in.pt"))

    # the JAX side on a mesh of the same D
    cfg = JRaster(backend="dense", k_cap=K_CAP)
    valid = jnp.ones((N,), bool)
    bg = jnp.asarray(inp["bg"])
    gm = jgauss_mesh(D)
    jg = jgauss_fn(gm, cam, cfg)(*jshard(gm, *g, valid), bg)
    tm = jtile_mesh(D)
    jt = jtile_fn(tm, cam, cfg)(*jshard(tm, *g, valid), bg)
    jdrop = int(jtile_fn(tm, dcam, JRaster(backend="dense", k_cap=1 << 14),
                         k_exch=8)(*jshard(tm, *dg, jnp.ones((2048,), bool)),
                                   jnp.zeros(3))[3])
    return {"D": D, "coll": coll, "res": res, "jax_gauss": jg,
            "jax_tile": jt, "jax_drop": jdrop}


def test_collectives_match_closed_forms(sharded):
    D = sharded["D"]
    for r, o in enumerate(sharded["coll"]):
        np.testing.assert_array_equal(o["psum"], [D * (D - 1) / 2, D])
        np.testing.assert_array_equal(o["psum_mean"], [(D - 1) / 2])
        np.testing.assert_array_equal(o["pmax"], [0, D - 1])
        np.testing.assert_array_equal(o["broadcast"], [6.0])
        np.testing.assert_array_equal(o["tree"]["a"],
                                      np.full((2, 2), D * (D - 1) / 2))
        assert float(o["tree"]["b"]) == 3.0 * D
        np.testing.assert_array_equal(o["tree"]["c"], [D * (D - 1) // 2])
        assert o["transport"] == "gloo"
        want = np.concatenate([np.arange(1.0, 4.0) * (s + 1)
                               for s in range(D)])[:, None]
        np.testing.assert_array_equal(o["gather"], want)
        w = np.arange(1.0, 3.0 * D + 1)[3 * r:3 * r + 3, None]
        np.testing.assert_array_equal(o["gather_grad"], D * w)
        np.testing.assert_array_equal(
            o["a2a"], [[10.0 * s + r] for s in range(D)])
        np.testing.assert_array_equal(
            o["a2a_grad"], [[(r + 1.0) * (d + 1)] for d in range(D)])
        if D == 4:
            (dr, di, ds), (sr, si, ss) = o["grid"]["data"], o["grid"]["shard"]
            assert sr == [2 * (r // 2), 2 * (r // 2) + 1] and si == r % 2
            assert dr == [r % 2, r % 2 + 2] and di == r // 2
            np.testing.assert_array_equal(ss, [sum(sr)])
            np.testing.assert_array_equal(ds, [sum(dr)])


def test_sharded_renders_equal_rasterize_to_the_bit(sharded):
    for o in sharded["res"]:
        for k in ("rgb", "depth", "alpha"):
            np.testing.assert_array_equal(o["gauss"][k], o["ref"][k], err_msg=k)
            np.testing.assert_array_equal(o["tile"][k], o["ref"][k], err_msg=k)
        assert o["tile"]["dropped"] == 0
    # the replicated image is the same on every rank
    for o in sharded["res"][1:]:
        np.testing.assert_array_equal(o["tile"]["rgb"],
                                      sharded["res"][0]["tile"]["rgb"])


def test_sharded_renders_match_jax(sharded):
    o = sharded["res"][0]
    jg, jt = sharded["jax_gauss"], sharded["jax_tile"]
    for got, want in ((o["gauss"], jg), (o["tile"], jt)):
        np.testing.assert_allclose(got["rgb"], np.asarray(want[0]), atol=2e-6)
        np.testing.assert_allclose(got["depth"], np.asarray(want[1]),
                                   atol=1e-5)
        np.testing.assert_allclose(got["alpha"], np.asarray(want[2]),
                                   atol=2e-6)
    assert int(jt[3]) == o["tile"]["dropped"] == 0


def test_tile_sharded_gradient_matches_single_device(sharded):
    for o in sharded["res"]:
        np.testing.assert_allclose(o["tile_grad"], o["ref_grad"], rtol=1e-4,
                                   atol=1e-6)
        assert np.abs(o["tile_grad"]).sum() > 0


def test_exchange_drops_with_small_buckets_as_jax(sharded):
    for o in sharded["res"]:
        assert o["drop_case"]["finite"]
        assert o["drop_case"]["dropped"] == sharded["jax_drop"] > 0


def test_tile_sharded_single_rank_renders_where_jax_raises(tmp_path):
    """ROADMAP Queue 3: vegs_tpu/parallel/tile_sharded.py:221 reads `me`,
    which its ndev == 1 branch never defines."""
    cam, g = _inputs()
    cfg = JRaster(backend="dense", k_cap=K_CAP)
    mesh = jtile_mesh(1)
    with pytest.raises(NameError):
        jtile_fn(mesh, cam, cfg)(*g, jnp.ones((N,), bool), jnp.zeros(3))
    torch.save({"cam": cam_numpy(cam), "gaussians": [np.asarray(x) for x in g],
                "bg": np.zeros(3, np.float32), "k_cap": K_CAP},
               tmp_path / "in.pt")
    (o,) = _spawn(tmp_path, workers.renders, 1, str(tmp_path / "in.pt"))
    for k in ("rgb", "depth", "alpha"):
        np.testing.assert_array_equal(o["tile"][k], o["ref"][k], err_msg=k)
    np.testing.assert_array_equal(o["tile_grad"], o["ref_grad"])


def test_spawn_fails_when_a_rank_fails_and_nccl_needs_cards(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        _spawn(tmp_path, workers.fail_on_rank_one, 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="a card per rank"):
            launch.spawn(workers.fail_on_rank_one, 2, backend="nccl",
                         init_file=tmp_path / "other")


def test_kcap_adapter_matches_jax():
    seq = ([(0, 3e4)] * 3 + [(5, 7e4)] + [(0, 1e4)] * 5 + [(0, 9e4)]
           + [(0, 1e4)] * 6 + [(1, 2e5)] * 3)
    a, b = KCapAdapter(1 << 16, decay_window=4, k_cap_max=1 << 18), \
        JAdapter(1 << 16, decay_window=4, k_cap_max=1 << 18)
    got = [a.update(*x) for x in seq]
    want = [b.update(*x) for x in seq]
    assert got == want and a.k_cap == b.k_cap
    assert any(v is not None and v < 1 << 16 for v in got)   # a decay
    assert any(v is not None and v > 1 << 16 for v in got)   # a growth


def _jax_state(seed=3, n=400, cap=512):
    prng = np.random.default_rng(seed)
    f = jgauss.create_from_points(
        prng.normal(size=(n, 3)).astype(np.float32),
        prng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap)
    opt = joptim.adam_init(f)
    opt = opt.replace(mu=jax.tree.map(lambda x: x + 0.5, opt.mu))
    st = JStats(max_radii2d=jnp.asarray(prng.uniform(0, 9, cap), jnp.float32),
                xyz_gradient_accum=jnp.asarray(prng.uniform(0, 1, cap),
                                               jnp.float32),
                denom=jnp.ones(cap))
    return f, opt, st


def test_converter_shards_like_jax_and_round_trips():
    f, opt, st = _jax_state()
    tree = {"field": {k: np.asarray(getattr(f, k)) for k in convert.FIELD_KEYS},
            "opt": {**{m: {k: np.asarray(getattr(getattr(opt, m), k))
                           for k in convert.PARAM_LEAVES}
                       for m in ("mu", "nu")}, "count": int(opt.count)},
            "stats": {k: np.asarray(getattr(st, k))
                      for k in convert.STATS_KEYS},
            "step": 7}
    D = 4
    blocks = [convert.shard_state_numpy(tree, d, D) for d in range(D)]
    back = convert.unshard_state_numpy(blocks)
    for part in ("field", "stats"):
        for k, v in tree[part].items():
            np.testing.assert_array_equal(back[part][k], v)
    for m in ("mu", "nu"):
        for k, v in tree["opt"][m].items():
            np.testing.assert_array_equal(back["opt"][m][k], v)
    assert back["opt"]["count"] == tree["opt"]["count"] and back["step"] == 7
    # the blocks are the JAX package's per-device shards, device d block d
    sf, so, ss = jshard_state(jtile_mesh(D), f, opt, st)
    for d in range(D):
        np.testing.assert_array_equal(
            blocks[d]["field"]["means"],
            np.asarray(sf.means.addressable_shards[d].data))
        np.testing.assert_array_equal(
            blocks[d]["opt"]["mu"]["sh_dc"],
            np.asarray(so.mu.sh_dc.addressable_shards[d].data))
        np.testing.assert_array_equal(
            blocks[d]["stats"]["max_radii2d"],
            np.asarray(ss.max_radii2d.addressable_shards[d].data))
    # a block loads as the port's state
    part = convert.train_state_from_numpy(blocks[1], device="cpu")
    assert part.field.capacity == 512 // D
    with pytest.raises(ValueError, match="do not split"):
        convert.shard_state_numpy(tree, 0, 3)


def test_sharded_state_bytes_matches_jax():
    pts = np.random.default_rng(0).normal(size=(1024, 3)).astype(np.float32)
    jf = jgauss.create_from_points(pts, capacity=1 << 16)
    tf = create_from_points(pts, capacity=1 << 16, device="cpu")
    assert sharded_state_bytes(tf, 8) == jstate_bytes(jf, 8)


def test_dryrun_and_scaling_bench_run_on_gloo_ranks():
    from vegs_torch.parallel import bench_scaling
    from vegs_torch.parallel.dryrun import dryrun_multichip

    r = dryrun_multichip(2, device="cpu")
    assert np.isfinite(r["loss"]) and np.isfinite(r["tp_loss"])
    assert r["transport"] == "gloo"
    dp = bench_scaling.run([1, 2], n_gaussians=2000, height=32, width=64,
                           iters=1, device="cpu", k_cap=1 << 14)
    tile = bench_scaling.run_tile([1, 2], n_gaussians=2000, height=32,
                                  width=64, iters=1, device="cpu",
                                  k_cap=1 << 14)
    for res in (dp, tile):
        assert sorted(res) == [1, 2]
        assert all(v["rays_per_s"] > 0 and v["transport"] == "gloo"
                   for v in res.values())
    assert dp[1]["scaling_eff"] == 1.0 and tile[1]["speedup"] == 1.0
