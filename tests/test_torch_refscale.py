"""The port's stage split and roofline (vegs_torch/perf/refscale.py and
roofline.py) against perf/r09_refscale.py, loaded by path and cut to a
small size inside this process (64x256, 3,000 Gaussians): the same scene
and camera, the same sized capacities (binning and K4 are bit-exact), then
`refscale` and `roofline` end to end on the CPU.

Both sides probe at a capacity of 2^16 slots instead of r09's 2^23 - 512:
it holds this scene's needs (~3.7k raw, 16k padded), so the sizing is the
same, and it keeps the JAX binning off 8M-slot arrays."""

import importlib.util
import os
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX side of the comparison; CPU per conftest)

from vegs_torch.perf import refscale, roofline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W, N = 64, 256, 3000
PROBE_CAP = 1 << 16


def load_r09(cache_dir):
    """perf/r09_refscale.py as a module, its H, W, N cut to the test size
    and its binning capped at PROBE_CAP slots. The module's import sets a
    compilation-cache variable and extends sys.path: both are restored."""
    env, path = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    spec = importlib.util.spec_from_file_location(
        "r09_refscale", ROOT / "perf" / "r09_refscale.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    mod.H, mod.W, mod.N = H, W, N
    b = mod.binning

    def capped(fn):
        def call(m2d, d, r, grid, k_cap, *a, **kw):
            return fn(m2d, d, r, grid, min(k_cap, PROBE_CAP), *a, **kw)
        return call

    mod.binning = types.SimpleNamespace(
        **{**vars(b), "bin_raw": capped(b.bin_raw),
           "bin_gaussians": capped(b.bin_gaussians)})
    return mod


@pytest.fixture(scope="module")
def r09(tmp_path_factory):
    return load_r09(tmp_path_factory.mktemp("jax_cache"))


@pytest.fixture
def port_cap(monkeypatch):
    monkeypatch.setattr(refscale, "PROBE_CAP", PROBE_CAP)


def test_build_scene_same_arrays_and_camera(r09):
    jcam, *jarrays = r09.build_scene()
    cam, arrays = refscale.build_scene(N, H, W, device="cpu")
    for name, j, t in zip(("means", "quats", "scales", "opacities", "shs"),
                          jarrays, arrays):
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    for f in ("viewmatrix", "projmatrix", "campos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(cam, f).numpy(),
                                   np.asarray(getattr(jcam, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    assert (cam.height, cam.width) == (H, W)


@pytest.mark.parametrize("sat", [True, False])
def test_size_caps_same_needs_and_capacities(r09, port_cap, capsys, sat):
    grid_j, k_cap_j, k_pad_j = r09.size_caps(*r09.build_scene(), 16, 16,
                                             sat=sat)
    line = capsys.readouterr().out
    m = re.search(r"raw need (\d+) -> (\d+), padded need (\d+) -> (\d+)",
                  line)
    assert m, line
    need_raw, k_cap, need_pad, k_pad = (int(x) for x in m.groups())
    assert (k_cap, k_pad) == (k_cap_j, k_pad_j)
    cam, arrays = refscale.build_scene(N, H, W, device="cpu")
    caps = refscale.size_caps(cam, arrays, 16, 16, sat=sat)
    assert (caps.need_raw, caps.k_cap, caps.need_pad, caps.k_pad) == (
        need_raw, k_cap, need_pad, k_pad)
    assert (caps.grid.ntx, caps.grid.nty) == (grid_j.ntx, grid_j.nty)
    assert k_cap < PROBE_CAP and k_pad < PROBE_CAP  # the cap does not bite


def test_refscale_and_roofline_end_to_end_on_cpu(port_cap):
    lines = []
    res = refscale.run(device="cpu", n=N, h=H, w=W, iters=1, warmup=0,
                       work=True, emit=lambda **kw: lines.append(kw))
    stages = [ln["stage"] for ln in lines if "stage" in ln]
    assert stages == list(res["stages"])  # no Mpix/s line without a card
    assert set(roofline.stage_work(res["counts"])) == set(res["stages"])
    for t in res["stages"].values():
        assert set(t) == {"cpu_ms"} and t["cpu_ms"] > 0  # never a card time
    stats = {ln["stat"]: ln for ln in lines if "stat" in ln}
    assert stats["satcull keeps"]["kept"] <= stats["satcull keeps"]["real"]
    assert stats["kept instances"]["kept"] == res["counts"]["columns"]
    assert all(ln["card"] == "cpu" for ln in lines)
    pairs = res["counts"]["pairs_k1"]
    assert pairs["walked"] >= pairs["tested"] >= pairs["included"] > 0

    rows = roofline.table(res, emit=lambda **kw: None)
    assert [r["stage"] for r in rows] == list(res["stages"])
    bounded = [r for r in rows if "bound_ms" in r]
    assert len(bounded) == len(rows) - 1  # the sort has no bound
    assert all(r["bound_ms"] > 0 and "share" not in r for r in bounded)


def test_roofline_fails_on_a_share_over_one():
    res = {"stages": {"K1 blend fwd": {"ms": 1e-6}}, "card": "x",
           "counts": {"n": 10, "k_cap": 512, "k_pad": 512, "tiles": 2,
                      "hp": 16, "wp": 32, "aux_bytes": 2, "sh_coeffs": 16,
                      "columns": 20, "sat": True,
                      "pairs_k1": {"walked": 100, "tested": 10,
                                   "included": 5, "slots": 50},
                      "pairs_k4": {"walked": 100, "tested": 10,
                                   "included": 5, "slots": 50}}}
    with pytest.raises(AssertionError, match="faster than its bound"):
        roofline.table(res, emit=lambda **kw: None)
    res["stages"]["K1 blend fwd"]["ms"] = 1.0
    (row,) = roofline.table(res, emit=lambda **kw: None)
    assert 0 < row["share"] < 1 and row["bound_by"] in ("bytes", "operations")


def test_refscale_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refscale.run(n=10, h=16, w=16)
