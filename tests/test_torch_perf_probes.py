"""The port's probes of the main path (vegs_torch/perf/tiles.py,
binning_probes.py, satcull_analysis.py, stages.py) against the JAX
package's perf/r05_tiles.py, r06_binning.py, r08_binning2.py,
r11_recscan.py and r09_satcull_analysis.py, each loaded by path (its
environment and sys.path restored) and run in this process at a small
size, its timer replaced by a recorder of the jitted function and its
arguments. Where a JAX function returns a sum of its result (jnp.sum(x)
.astype(float32)), the module's `jnp.sum` is replaced by `Keep`, which
hands the array itself back, so the arrays are compared, not the sums.

  * r05 and r08: the k_cap (and r08's k_pad) sizing at each tile shape
    equal to JAX's (both probe at 2^16 slots: the scene needs far less);
  * r06: on JAX's own inputs, the current slot map and the delta map equal
    to JAX's to the bit, the delta map equal to the current one (r06's
    exactness check), and the port's inputs from JAX's projection equal
    JAX's;
  * r08: `pad_relayout` with and without keys equal to JAX's in carry,
    keys and starts, and the two variants' carries equal;
  * r11: the drawn data equal to the bit, the row scatter, the blocked
    cumsum and the row gather equal to JAX's, and the scatter-and-cumsum
    reconstruction of the row gather exact on both sides;
  * r09: on JAX's own projection of a saturating toy scene at 376x1408
    (2,000 Gaussians, scales 0.05-0.5; bin_raw capped at 2^19 slots), the
    real, counted and conservatively culled counts equal, and the printed
    shares (kept per tile, the sampled oracle, the suffix culls) equal at
    the script's own precision;
  * the stage split and bisect at a toy size on the CPU: every stage timed
    (the host's clock, never a device number) and bounded.
"""

import importlib.util
import io
import os
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vegs_torch.ops import binning as tbin
from vegs_torch.perf import binning_probes as bp
from vegs_torch.perf import refscale, satcull_analysis, stages, tiles

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W, N = 64, 256, 3000
CAP = 1 << 16
ACC0 = jnp.float32(0.0)  # the timing loops' carried accumulator


class Keep:
    """Stands in for jnp.sum(x): keeps x through .astype and * scale."""

    def __init__(self, x):
        self.x = np.asarray(x)

    def astype(self, _):
        return self

    def __mul__(self, _):
        return self


def load(name, cache_dir, **attrs):
    """perf/<name>.py as a module, with `attrs` set on it. Its import may
    set a compilation-cache variable and extend sys.path: both are
    restored."""
    env, path = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "perf" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def recorder():
    calls = {}

    def timeit(name, fn, args, iters=8):
        calls[name.strip()] = (fn, args)
        return 0.0
    return calls, timeit


def keep_jnp():
    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.sum = Keep
    return ns


def _t(x):
    return torch.from_numpy(np.array(x))


def capped(fn, cap):
    def call(m2d, d, r, grid, k_cap, *a, **kw):
        return fn(m2d, d, r, grid, min(k_cap, cap), *a, **kw)
    return call


# -- r05 / r08: sizing ---------------------------------------------------------


def test_r05_k_cap_sizing_matches_jax(tmp_path, monkeypatch, capsys):
    import vegs_tpu.ops.rasterize as jr

    mod = load("r05_tiles", tmp_path, H=H, W=W, N=N, K_CAP=CAP, ITERS=1)

    def fake(m, q, s, o, sh, cam, bg=None, config=None):
        z = jnp.sum(m) * 0.0
        return types.SimpleNamespace(rgb=jnp.zeros((3, 2, 2)) + z,
                                     depth=jnp.zeros((1, 2, 2)) + z)

    monkeypatch.setattr(jr, "rasterize", fake)
    monkeypatch.setattr(sys, "argv", ["r05_tiles.py"])
    mod.main()
    got = [__import__("json").loads(ln) for ln in
           capsys.readouterr().out.splitlines() if ln.startswith("{")]
    jax_caps = {g["tile"]: g["k_cap"] for g in got}
    assert list(jax_caps) == ["16x16", "16x32", "32x32", "32x16"]
    cam, arrays = refscale.build_scene(N, H, W, "cpu")
    for th, tw in tiles.SHAPES:
        sized = tiles.size_k_cap(cam, arrays, th, tw, CAP)
        assert sized["k_cap"] == jax_caps[f"{th}x{tw}"], (th, tw, sized)


def test_r08_caps_match_jax(tmp_path, monkeypatch, capsys):
    import vegs_tpu.ops.binning as jb

    mod = load("r08_binning2", tmp_path, H=H, W=W, N=N)
    mod.timeit = recorder()[1]
    monkeypatch.setattr(jb, "bin_raw", capped(jb.bin_raw, CAP))
    mod.main()
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("k_raw"))
    k_raw, k_pad, kept = (int(x) for x in re.findall(r"\d+", line))
    cam, arrays = refscale.build_scene(N, H, W, "cpu")
    grid = tbin.TileGrid.for_image(H, W, *bp.R08_TILE)
    caps = bp.r08_caps(*bp.projected(cam, arrays), grid, probe=CAP)
    assert (caps["k_raw"], caps["k_pad"], caps["kept"]) == (k_raw, k_pad, kept)


def test_r08_relayouts_match_jax():
    import vegs_tpu.ops.binning as jb

    from tests.utils import make_camera
    from vegs_tpu import geometry as jgeo
    from vegs_tpu.ops.projection import project as jproject

    cam, arrays = refscale.build_scene(N, H, W, "cpu")
    jcam = make_camera(height=H, width=W, fovx=1.2, fovy=0.4)
    means, quats, scales, opac, shs = (jnp.asarray(x.numpy()) for x in arrays)
    p = jproject(means, jgeo.cov6_from_scaling_rotation(scales, quats), opac,
                 shs, jcam)
    grid = jb.TileGrid.for_image(H, W, *bp.R08_TILE)
    rb = jb.bin_raw(p.means2d, p.depths, p.radii_xy, grid, CAP,
                    conics=p.conics, opacities=p.opacities)
    k_pad = 1 << 14
    args = (rb.key_sorted, rb.gidx_sorted, rb.raw_starts, grid.num_tiles,
            k_pad)
    targs = (*(_t(x) for x in args[:3]), grid.num_tiles, k_pad)
    port = {}
    for keys in (False, True):
        j = jb.pad_relayout(*args, dummy=N, want_keys=keys)
        t = tbin.pad_relayout(*targs, dummy=N, want_keys=keys)
        port[keys] = t
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
        assert int(t[3]) == int(j[3]) > 0
        if keys:
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        else:
            assert t[1] is None
    assert torch.equal(port[False][0], port[True][0])


# -- r06 ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def r06(tmp_path_factory):
    k = 1 << 14
    mod = load("r06_binning", tmp_path_factory.mktemp("jax_cache"), H=H, W=W,
               N=N, K_CAP=k)
    calls, mod.timeit = recorder()
    mod.jnp = keep_jnp()
    out = io.StringIO()
    stdout, sys.stdout = sys.stdout, out
    try:
        mod.main()
    finally:
        sys.stdout = stdout
    return k, calls, out.getvalue()


def test_r06_maps_match_jax_to_the_bit(r06):
    k, calls, printed = r06
    assert "delta-map exactness: rec cols True, gidx col True" in printed
    cur_fn, cur_args = calls["CURRENT slot map: sort2 + scatter + cumsum1 + "
                             "row8-gather"]
    del_fn, del_args = calls["DELTA slot map: 2x row9-scatter(uns) + cumsum9"]
    jcur = cur_fn(cur_args, ACC0).x
    jdel = del_fn(del_args, ACC0).x
    ce, rd, ne, rec = (_t(x) for x in cur_args)
    tcur, gidx = bp.cur_map(k, ce, rd, ne, rec)
    np.testing.assert_array_equal(tcur.numpy(), jcur)
    ce2, cu, ne2, rec9 = (_t(x) for x in del_args)
    tdel = bp.delta_map(k, ce2, cu, ne2, rec9)
    np.testing.assert_array_equal(tdel.numpy(), jdel)
    inp = {"cum_excl": ce, "cum": cu, "nonempty": ne, "rec": rec,
           "rec9": rec9, "run_delta": rd}
    exact = bp.delta_exact(k, inp)
    assert exact["rec_cols"] and exact["gidx_col"] and exact["nr"] > 1000


def test_r06_inputs_from_jax_projection_match(r06):
    k, calls, _ = r06
    _, raw_args = calls["bin_raw only"]
    _, cur_args = calls["CURRENT slot map: sort2 + scatter + cumsum1 + "
                        "row8-gather"]
    _, del_args = calls["DELTA slot map: 2x row9-scatter(uns) + cumsum9"]
    m2d, dpt, rxy, con, ops_ = (_t(x) for x in raw_args)
    inp = bp.r06_inputs(m2d, dpt, rxy, con, ops_, tbin.TileGrid.for_image(H, W))
    want = {"cum_excl": cur_args[0], "run_delta": cur_args[1],
            "nonempty": cur_args[2], "rec": cur_args[3], "cum": del_args[1],
            "rec9": del_args[3]}
    for name, ref in want.items():
        np.testing.assert_array_equal(inp[name].numpy(), np.asarray(ref),
                                      err_msg=name)


# -- r11 ---------------------------------------------------------------------


def test_r11_data_and_ops_match_jax(tmp_path):
    n, k = 4096, 1 << 14
    mod = load("r11_recscan", tmp_path, N=n, K=k)
    calls, mod.timeit = recorder()
    mod.jnp = keep_jnp()
    mod.main()
    d = bp.r11_data(n, k)
    keys, vals, rec, starts, gidx = (d[x] for x in ("keys", "vals", "rec",
                                                    "starts", "gidx"))
    _, (jkeys, jvals) = calls[f"sort 2-op over n={n}"]
    scat_fn, (jstarts, jrec) = calls["row-8 scatter n->k at sorted unique idx"]
    cs_fn, _ = calls[f"[{k}, 8] int32 blocked cumsum"]
    g_fn, (_, jgidx) = calls[f"row-8 gather [n]->[k={k}] (current rec path)"]
    for a, b in ((keys, jkeys), (vals, jvals), (rec, jrec),
                 (starts, jstarts), (gidx, jgidx)):
        np.testing.assert_array_equal(a, np.asarray(b))
    t = {x: torch.from_numpy(v) for x, v in d.items()}
    jz = scat_fn((jstarts, jrec), ACC0)[1].x
    tz = bp._scatter_add(k, t["starts"], t["rec"])
    np.testing.assert_array_equal(tz.numpy(), jz)
    np.testing.assert_array_equal(
        bp.blocked_cumsum(tz).numpy(), cs_fn((jnp.asarray(jz),), ACC0)[1].x)
    np.testing.assert_array_equal(t["rec"][t["gidx"].long()].numpy(),
                                  g_fn((jrec, jgidx), ACC0)[1].x)
    # the reconstruction: deltas (int32, wrapping) scattered at the run
    # starts and cumsummed give the gather by run, on both sides
    delta = rec.copy()
    delta[1:] -= rec[:-1]
    run = np.clip(np.searchsorted(starts, np.arange(k), side="right") - 1, 0,
                  None).astype(np.int32)
    jscan = cs_fn((jnp.asarray(scat_fn((jstarts, jnp.asarray(delta)), ACC0)
                               [1].x),), ACC0)[1].x
    jgath = g_fn((jrec, jnp.asarray(run)), ACC0)[1].x.copy()
    jgath[:starts[0]] = 0
    np.testing.assert_array_equal(jscan, jgath)
    np.testing.assert_array_equal(
        bp.rec_by_scan(t["rec"], t["starts"], k).numpy(), jgath)
    assert bp.scan_exact(t["rec"], t["starts"], k)


# -- r09 ---------------------------------------------------------------------


def test_r09_counts_match_jax(tmp_path, monkeypatch, capsys):
    import tests.utils as tu
    import vegs_tpu.ops.binning as jb
    import vegs_tpu.ops.projection as jp

    mod = load("r09_satcull_analysis", tmp_path)
    cap = 1 << 19
    monkeypatch.setenv("VEGS_SAT_N", "2000")
    monkeypatch.setattr(jb, "bin_raw", capped(jb.bin_raw, cap))
    big = tu.random_gaussians

    def saturating(rng, n, depth_range, xy_extent, scale_range):
        return big(rng, n, depth_range=depth_range, xy_extent=xy_extent,
                   scale_range=(0.05, 0.5))
    monkeypatch.setattr(tu, "random_gaussians", saturating)
    seen = {}
    project = jp.project

    def recording(*a, **kw):
        seen["proj"] = project(*a, **kw)
        return seen["proj"]
    monkeypatch.setattr(jp, "project", recording)
    where = mod.np.where
    ns = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                  if not k.startswith("__")})

    def where_rec(c, *a):
        seen.setdefault("counted", np.asarray(c))
        return where(c, *a)
    ns.where = where_rec
    mod.np = ns
    mod.main()
    printed = capsys.readouterr().out
    p = seen["proj"]
    grid = tbin.TileGrid.for_image(376, 1408)
    res = satcull_analysis.analyse(
        *(_t(x) for x in (p.means2d, p.depths, p.radii_xy, p.conics,
                          p.opacities)), grid, k_cap=cap)
    assert res["culled"] > 0 and res["counted"] > 0  # the scene saturates
    assert f"real instances={res['real']}, tiles={grid.num_tiles}" in printed
    assert res["counted"] == int(seen["counted"].sum())
    lines = [
        f"counted (alpha_min >= 1/255): {res['counted_share'] * 100:.1f}%",
        f"conservative tile-saturation cull: {res['culled']} "
        f"({res['culled_share'] * 100:.1f}% of instances)",
        f"median kept/tile {res['median_kept_per_tile']:.0f} of "
        f"{res['median_per_tile']:.0f}",
        f"oracle (sampled {res['sampled_tiles']} tiles): "
        f"{res['oracle_share'] * 100:.1f}% contribute nothing; conservative "
        f"got {res['conservative_in_sample_share'] * 100:.1f}%",
        f"suffix cull (all pixels saturated): exact "
        f"{res['suffix_exact_share'] * 100:.1f}%, 256-chunk granular "
        f"{res['suffix_256_share'] * 100:.1f}%"]
    for ln in lines:
        assert ln in printed, (ln, printed)


# -- the stage split and bisect, on the CPU -------------------------------


def test_stages_and_bisect_run_on_the_cpu():
    kw = dict(device="cpu", n=N, h=H, w=W, k_cap=1 << 15, iters=1, warmup=1)
    lines = []
    r = stages.run(**kw, emit=lambda **x: lines.append(x))
    assert r["counts"]["dropped"] == 0 and r["card"] == "cpu"
    names = set(r["stages"])
    assert {"full forward", "full fwd+bwd", "project (forward)",
            "blend fwd+bwd (K1+K2)"} <= names
    for line in r["stages"].values():
        assert "cpu_ms" in line and "ms" not in line and "device_ms" not in line
        assert line["bound_ms"] > 0
    b = stages.bisect(**kw, emit=lambda **x: lines.append(x))
    assert list(b) == [f"{w} upto {s}" for s in stages.BISECT
                       for w in ("fwd", "fwd+bwd")]
