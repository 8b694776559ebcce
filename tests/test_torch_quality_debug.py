"""The port's quality debug trails (vegs_torch/perf/quality_debug.py)
against perf/r12_quality_debug.py and perf/r12b_grads.py, loaded by path
(with perf/quality_full.py and quality_full_r05.py, on the dense backend:
VEGS_QUALITY_BACKEND=dense; environment and sys.path restored) at 32x64,
each on its own package's scene and arm-A Trainer from numpy seed 7 (17
cameras), with the f32 aux payload on both sides (`PAYLOAD`). The JAX
Trainer runs at k_cap 2^14 instead of 2^17: its dense
spec is O(k_cap x pixels), and this scene needs ~9.5k padded slots, so
nothing is dropped at either capacity. The JAX scripts' arrays are read
where they pass through `np.asarray` (the module's `np` is wrapped).

  * r12's init statistics of the first held-out view: the render's mean,
    max and alpha coverage and the view's PSNR within 1e-5 (relative for
    the PSNR), the same padded and raw needs, nothing dropped; the ground
    truth's mean and max equal.
  * r12b's loss (printed to 4 decimals) within 1e-4; the rms and max of
    the gradient of each group (means, sh_dc, the opacity logit, the
    log-scales) within 1e-4 relative; its nonzero entries the same but
    where both sides are within 1e-5 of the group's largest |g| (a few
    dozen of 12,288 rows carry ~1e-9 contributions that one side rounds to
    zero: the dense spec and the tile walk sum them in another order);
    the quadrant means within 1e-5.
"""

import importlib.util
import os
import re
import sys
import types
from pathlib import Path

import jax  # noqa: F401  (the JAX side; CPU per conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vegs_torch.perf import quality_debug as qd

ROOT = Path(__file__).resolve().parents[1]
H, W = 32, 64
JAX_K_CAP = 1 << 14
STAT_TOL, GRAD_RTOL = 1e-5, 1e-4
NOISE = 1e-5  # of a group's largest |gradient|: see test_r12b_grads_match_jax
# r12b's gradients are compared with the aux payload (rgb, quat, scale) in
# f32 on both sides: with bf16 aux, the colour and scale groups' gradients
# round to bf16 at other places in the two packages (one bf16 step is
# 2^-8 of a value)
PAYLOAD = "f32"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Seen:
    """A stand-in for a module's numpy whose `asarray` records what it
    converts."""

    def __init__(self):
        self.arrays = []
        for k in dir(np):
            if not k.startswith("__") and k != "asarray":
                setattr(self, k, getattr(np, k))

    def asarray(self, x, *a, **kw):
        y = np.asarray(x, *a, **kw)
        self.arrays.append(y)
        return y


@pytest.fixture(scope="module")
def jscripts(tmp_path_factory):
    """r12 and r12b as modules, their Trainers at JAX_K_CAP."""
    env, path = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(
        tmp_path_factory.mktemp("jax_cache"))
    os.environ["VEGS_QUALITY_BACKEND"] = "dense"
    mods = {}
    try:
        sys.path.insert(0, str(ROOT / "perf"))
        for name in ("quality_full", "quality_full_r04", "quality_full_r05",
                     "r12_quality_debug", "r12b_grads"):
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "perf" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            sys.modules[name] = mods[name]  # the later ones import the first
            spec.loader.exec_module(mods[name])
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    qf5 = mods["quality_full_r05"]
    build = qf5.build_trainer

    def at_test_cap(*a, **kw):
        tr = build(*a, **kw)
        tr.raster_cfg = tr.raster_cfg._replace(k_cap=JAX_K_CAP,
                                               payload_dtype=PAYLOAD)
        return tr
    qf5.build_trainer = at_test_cap
    return mods["r12_quality_debug"], mods["r12b_grads"]


@pytest.fixture
def f32_payload(monkeypatch):
    """The port's arm-A Trainer with the f32 aux payload (see PAYLOAD)."""
    build = qd.debug_trainer

    def f32(*a, **kw):
        tr, info = build(*a, **kw)
        tr.raster_cfg = tr.raster_cfg._replace(payload_dtype=PAYLOAD)
        return tr, info
    monkeypatch.setattr(qd, "debug_trainer", f32)


def test_r12_init_stats_match_jax(jscripts, capsys, f32_payload):
    r12, _ = jscripts
    seen = Seen()
    r12.np = seen
    r12.probe(H, W, iters=0)
    printed = capsys.readouterr().out
    gt0, rgb, alpha, gt = seen.arrays[:4]
    mse = float(((rgb - gt) ** 2).mean())
    jstats = {"mean": rgb.mean(), "max": rgb.max(),
              "alpha_cov": float((alpha > 0.5).mean()),
              "psnr1": -10 * np.log10(mse + 1e-12)}
    dropped, needed = (int(x) for x in re.search(
        r"dropped (\d+) needed (\d+)/", printed).groups())
    raw = int(re.search(r"raw (\d+)/", printed).group(1))
    res = qd.probe(H, W, iters=0, device="cpu", log=lambda _: None)
    got = res["stats"]["init"]
    assert (res["gt_mean"], res["gt_max"]) == (float(gt0.mean()),
                                               float(gt0.max()))
    for k in ("mean", "max", "alpha_cov"):
        assert abs(got[k] - float(jstats[k])) <= STAT_TOL, (k, got, jstats)
    assert abs(got["psnr1"] - jstats["psnr1"]) <= STAT_TOL * jstats["psnr1"]
    assert got["dropped"] == dropped == 0
    assert (got["needed"], got["needed_raw"]) == (needed, raw)
    assert 0.0 < got["alpha_cov"] < 1.0


def test_r12b_grads_match_jax(jscripts, capsys, f32_payload):
    _, r12b = jscripts
    seen = Seen()
    r12b.np = seen
    r12b.probe(H, W)
    printed = capsys.readouterr().out
    jloss = float(re.search(r"loss ([\d.]+)", printed).group(1))
    jgrads = dict(zip(("means", "sh_dc", "logit_op", "log_scales"),
                      seen.arrays[:4]))
    rgb, gtn = seen.arrays[4:6]
    res = qd.grads(H, W, device="cpu", log=lambda _: None)
    assert abs(res["loss"] - jloss) <= 1e-4  # printed to 4 decimals
    for name, g in jgrads.items():
        g = g.astype(np.float64)
        want = {"rms": np.sqrt((g ** 2).mean()), "max": np.abs(g).max()}
        got = res["grads"][name]
        assert want["rms"] > 0, name
        for k, v in want.items():
            assert abs(got[k] - v) <= GRAD_RTOL * abs(v), (name, k, got, want)
        # nonzero: the same entries, but where both sides are within
        # NOISE of the group's largest |g| (contributions the dense spec and
        # the tile walk round to zero at different places)
        t = res["arrays"][name].astype(np.float64)
        differ = (t != 0) != (g != 0)
        noise = NOISE * want["max"]
        assert not (differ & ((np.abs(t) > noise) | (np.abs(g) > noise))).any()
        assert abs(got["nonzero"] - float((t != 0).mean())) < 1e-12
        assert got["nonzero"] > 0.1
    hh, ww = H // 2, W // 2
    for qy in (0, 1):
        for qx in (0, 1):
            sl = np.s_[:, qy * hh:(qy + 1) * hh, qx * ww:(qx + 1) * ww]
            q = res["quads"][f"{qy},{qx}"]
            assert abs(q["render"] - float(rgb[sl].mean())) <= STAT_TOL
            assert abs(q["gt"] - float(gtn[sl].mean())) <= STAT_TOL


def test_zero_clamps_split_the_gradient_as_jax():
    """Where a clamped value sits exactly on its bound, the port passes
    half the gradient, as jnp.maximum does (torch.clamp passes all of it):
    a Gaussian whose colour is exactly 0 (its sh_dc gradient was twice
    JAX's). SSIM's variances, clamped the same way, are exactly 0 over a
    flat window, where their own gradient is ~0: its gradients against
    JAX's there as a parity check."""
    from tests.utils import make_camera
    from vegs_tpu.losses import photometric as jphoto
    from vegs_tpu.ops.projection import project as jproject
    from vegs_torch.convert import camera_params_from_numpy
    from vegs_torch.losses import photometric as tphoto
    from vegs_torch.ops.projection import project as tproject
    from vegs_torch.sh import C0

    # sh values whose colour C0 * sh + 0.5 is exactly 0 in float32
    c0 = np.float32(C0)
    cand = np.float32(-0.5 / C0) + np.arange(-64, 65, dtype=np.float32) * \
        np.spacing(np.float32(0.5 / C0))
    zero = cand[(c0 * cand + np.float32(0.5)) == 0]
    assert len(zero), "no float32 sh gives a colour of exactly 0"
    n = 4
    means = np.array([[0.0, 0.0, 4.0], [0.3, 0.1, 5.0], [-0.2, 0.2, 6.0],
                      [0.1, -0.3, 3.0]], np.float32)
    cov6 = np.tile(np.array([0.01, 0, 0, 0.01, 0, 0.01], np.float32), (n, 1))
    opac = np.full(n, 0.5, np.float32)
    shs = np.full((n, 1, 3), 0.3, np.float32)
    shs[0, 0, :] = zero[0]
    cam = make_camera(height=32, width=64)
    w = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)

    def jf(sh):
        p = jproject(jnp.asarray(means), jnp.asarray(cov6),
                     jnp.asarray(opac), sh, cam, sh_degree=0)
        return (p.rgb * w).sum()
    jg = np.asarray(jax.grad(jf)(jnp.asarray(shs)))
    tcam = camera_params_from_numpy(cam.viewmatrix, cam.projmatrix,
                                    cam.campos, cam.tan_fovx, cam.tan_fovy,
                                    32, 64, device="cpu")
    sh_t = torch.from_numpy(shs).requires_grad_(True)
    p = tproject(torch.from_numpy(means), torch.from_numpy(cov6),
                 torch.from_numpy(opac), sh_t, tcam, sh_degree=0)
    assert float(p.rgb[0].abs().max()) == 0.0
    (p.rgb * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(sh_t.grad.numpy(), jg, rtol=1e-6, atol=0)
    np.testing.assert_allclose(jg[0, 0], 0.5 * c0 * w[0], rtol=1e-6)

    flat = np.zeros((3, 16, 16), np.float32)
    other = np.random.default_rng(1).uniform(size=(3, 16, 16)).astype(
        np.float32)
    for a, b in ((flat, other), (other, flat)):
        jg = np.asarray(jax.grad(lambda x: jphoto.ssim(x, jnp.asarray(b)))(
            jnp.asarray(a)))
        x = torch.from_numpy(a).requires_grad_(True)
        tphoto.ssim(x, torch.from_numpy(b)).backward()
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-4,
                                   atol=1e-6 * np.abs(jg).max())
