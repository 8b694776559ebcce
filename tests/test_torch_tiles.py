"""Wide tiles (16x32, 32x16, 32x32) through the port against vegs_tpu.

  * `rasterize` at 64x128 on a 300-Gaussian scene with stratified depths
    (distinct keys within each tile: the JAX sort is unstable, the port's
    stable): the forward (the plain K1 and K4) against the JAX package's
    Pallas backend in interpret mode (as tests/test_blend_pallas.py:191
    runs it) on rgb, depth and alpha within 1e-5 of each one's largest
    |value| (depth, a weighted sum of depths up to 10, carries float32
    sums in another order), and the gradients of every leaf (through the
    plain K2 and K3) within a relative L2 error of 1e-4, sat cull on and
    off.
  * One static Trainer step at 16x32 tiles against the JAX Trainer (dense
    backend, O(k_cap x pixels)) from the same state on the toy scene of
    tests/test_training.py:19 (150 points, 48x64): the loss within rtol
    1e-4, every field parameter within 1e-4 (tests/test_torch_train.py's
    tolerances).
  * The tile-shape check (`blend_cuda.check_tile_shape`, also run by
    `rasterize`'s kernel backend on any device): it refuses every shape
    bench.py's own check refuses (tile_w not a multiple of 16), and beyond
    that only tiles over 1024 pixels or of an odd tile_h (no whole warps);
    it takes 512- and 1024-pixel tiles.
  * The plain K2 restricted to some tiles (`tiles=`, as chip_smoke.py holds
    the kernel on a subset at full width) gives those tiles' rows of the
    full walk.
"""

import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.utils import make_camera, random_gaussians
from vegs_tpu.config import VegsConfig as JConfig
from vegs_tpu.ops.rasterize import (RasterizeConfig as JRaster,
                                    rasterize as jrasterize)
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.train import Trainer as JTrainer, eval_render
from vegs_torch import convert
from vegs_torch.config import ModelParams
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import blend_cuda
from vegs_torch.ops.rasterize import (RasterizeConfig as TRaster,
                                      rasterize as trasterize, stage)
from vegs_torch.scene import Scene, dataset_readers as treaders
from vegs_torch.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 128
K = 1 << 14
TRAIN_K = 1 << 13  # the 48x64 grid at 16x32 tiles holds 24 tiles: <= 6,144
SHAPES = [(16, 32), (32, 16), (32, 32)]
IDS = ["16x32", "32x16", "32x32"]
FWD_ATOL, GRAD_RTOL = 1e-5, 1e-4
OUTPUTS = ("rgb", "depth", "cov_quat", "cov_scale", "alpha")
LEAVES = ("means", "quats", "scales", "opacities", "shs", "means2d")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed=0, n=300):
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, shs = [np.array(x) for x in random_gaussians(
        rng, n, depth_range=(1.5, 10.0), xy_extent=3.0,
        scale_range=(0.05, 0.4), opacity_range=(0.3, 0.99))]
    means[:, 2] = rng.permutation(np.linspace(1.5, 10.0, n)).astype(np.float32)
    cam = make_camera(height=H, width=W, fovx=1.0, fovy=0.5)
    tcam = camera_params_from_numpy(cam.viewmatrix, cam.projmatrix,
                                    cam.campos, cam.tan_fovx, cam.tan_fovy,
                                    H, W, device="cpu")
    return cam, tcam, (means, quats, scales, opac, shs)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("sat", [False, True], ids=["full", "sat_cull"])
@pytest.mark.parametrize("tile", SHAPES, ids=IDS)
def test_rasterize_matches_jax(tile, sat):
    th, tw = tile
    cam, tcam, arrays = _scene()
    n = arrays[0].shape[0]
    wts = [np.random.default_rng(5).normal(size=s).astype(np.float32)
           for s in ((3, H, W), (1, H, W), (4, H, W), (3, H, W), (1, H, W))]
    jcfg = JRaster(backend="pallas", k_cap=K, payload_dtype="f32",
                   sat_cull=sat, tile_h=th, tile_w=tw)

    def f(m, q, s, o, sh, off):
        out = jrasterize(m, q, s, o, sh, cam, means2d_offset=off, config=jcfg)
        return sum(jnp.sum(getattr(out, k) * w) for k, w in zip(OUTPUTS, wts))

    jargs = [jnp.asarray(a) for a in arrays] + [jnp.zeros((n, 2))]
    jout = jrasterize(*jargs[:5], cam, config=jcfg)
    gj = jax.grad(f, argnums=tuple(range(6)))(*jargs)

    ta = [_t(a).requires_grad_(True) for a in arrays]
    off = torch.zeros((n, 2), requires_grad=True)
    out = trasterize(*ta, tcam, means2d_offset=off,
                     config=TRaster(k_cap=K, payload_dtype="f32",
                                    sat_cull=sat, tile_h=th, tile_w=tw))
    assert int(out.num_dropped) == 0 == int(jout.num_dropped)
    for k in ("rgb", "depth", "alpha"):
        ref = np.asarray(getattr(jout, k))
        np.testing.assert_allclose(getattr(out, k).detach().numpy(), ref,
                                   rtol=0, atol=FWD_ATOL * np.abs(ref).max(),
                                   err_msg=k)
    assert float(out.alpha.detach().max()) > 0.5  # it covers the image
    sum((getattr(out, k) * _t(w)).sum() for k, w in zip(OUTPUTS, wts)
        ).backward()
    for name, a, b in zip(LEAVES, ta + [off], gj):
        ref = np.asarray(b)
        assert np.abs(ref).max() > 0, name
        err = _rel_l2(a.grad.numpy(), ref)
        assert err <= GRAD_RTOL, (name, err)


def _scene_info(readers, seed=0, n_pts=150, n_cams=6):
    """tests/test_training.py:19's toy scene (48x64 cameras)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.2, 0.8, (n_pts, 3)).astype(np.float32)
    pcd = readers.BasicPointCloud(pts, cols)
    cams = readers.generateRandomCameras(n_cams, camera_distance=4.0,
                                         width=64, height=48)
    return readers.SceneInfo(
        point_cloud=pcd, train_cameras=cams[:-1], test_cameras=cams[-1:],
        nerf_normalization=readers.getNerfppNorm(cams, pcd), ply_path="")


def _jax_state_numpy(state):
    return {
        "field": {k: np.asarray(getattr(state.field, k))
                  for k in convert.FIELD_KEYS},
        "opt": {**{m: {k: np.asarray(getattr(getattr(state.opt, m), k))
                       for k in convert.PARAM_LEAVES} for m in ("mu", "nu")},
                "count": int(state.opt.count)},
        "stats": {k: np.asarray(getattr(state.stats, k))
                  for k in convert.STATS_KEYS},
        "step": int(state.step),
    }


def test_trainer_step_16x32_matches_jax():
    jcfg = JConfig()
    jraster = JRaster(backend="dense", k_cap=TRAIN_K, tile_h=16, tile_w=32)
    js = JScene(jcfg.model, scene_info=_scene_info(jreaders), shuffle=False)
    jt = JTrainer(jcfg, js, raster_cfg=jraster)
    for cam in js.train_cameras + js.test_cameras:
        cam.image = np.clip(np.asarray(eval_render(
            jt.state.field, cam.device_params(), jt.bg, 3, jraster).rgb), 0, 1)
    f = jt.state.field
    jt.state = jt.state.replace(field=f.replace(sh_dc=f.sh_dc + 0.35))

    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ts = Scene(ModelParams(), scene_info=_scene_info(treaders), shuffle=False,
               device="cpu")
    for tc, jc in zip(ts.train_cameras + ts.test_cameras,
                      js.train_cameras + js.test_cameras):
        tc.image = jc.image
    tt = Trainer(tcfg, ts, raster_cfg=TRaster(k_cap=TRAIN_K, tile_h=16,
                                              tile_w=32), device="cpu")
    tt.state = convert.train_state_from_numpy(_jax_state_numpy(jt.state),
                                              device="cpu")
    ts.gaussians = tt.state.field
    jm = jt.train_iteration(1, camera=js.train_cameras[1])
    tm = tt.train_iteration(1, camera=ts.train_cameras[1])
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    assert int(tm["num_dropped"]) == int(jm["num_dropped"]) == 0
    got = convert.field_to_numpy(tt.state.field)
    for k in convert.FIELD_KEYS:
        ref = np.asarray(getattr(jt.state.field, k))
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-4, err_msg=k)
    moved = np.abs(got["sh_dc"] - (np.asarray(f.sh_dc) + 0.35)).max()
    assert moved > 1e-4  # the step did update the field


def _bench_refuses(tmp_path, th, tw) -> bool:
    """Whether bench.py's own tile check (run at its import) refuses
    VEGS_TILE_H/W = th, tw. Its import sets a compilation-cache variable
    and extends sys.path: both are restored."""
    env, path = dict(os.environ), list(sys.path)
    os.environ.update(JAX_COMPILATION_CACHE_DIR=str(tmp_path),
                      VEGS_TILE_H=str(th), VEGS_TILE_W=str(tw))
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        return False
    except SystemExit:
        return True
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path


def _port_refuses(th, tw) -> bool:
    try:
        blend_cuda.check_tile_shape(th, tw)
        return False
    except ValueError:
        return True


TRIAL_SHAPES = [(16, 16), (16, 32), (32, 16), (32, 32), (8, 16), (64, 16),
                (16, 48), (16, 64), (8, 128), (16, 8), (16, 24), (32, 20),
                (0, 16), (16, 0), (3, 16), (48, 32), (32, 64), (64, 64)]


def test_tile_shape_check_refuses_what_jax_refuses(tmp_path):
    for th, tw in TRIAL_SHAPES:
        jax_no = _bench_refuses(tmp_path, th, tw)
        port_no = _port_refuses(th, tw)
        p = th * tw
        beyond = p > blend_cuda.MAX_PIXELS or p % 32 != 0
        assert port_no == (jax_no or beyond), (th, tw, jax_no, port_no)
    for th, tw in ((16, 32), (32, 16), (32, 32), (64, 16), (16, 64)):
        assert th * tw in (512, 1024) and not _port_refuses(th, tw)


@pytest.mark.parametrize("tile", [(16, 24), (48, 32), (3, 16)],
                         ids=["16x24", "48x32", "3x16"])
def test_rasterize_refuses_a_shape_the_kernels_do_not_take(tile):
    """`rasterize`'s kernel backend refuses the shape on the CPU as the card
    would, before any stage runs; the dense spec takes any tile."""
    _, tcam, arrays = _scene(n=50)
    ta = [_t(a) for a in arrays]
    th, tw = tile
    with pytest.raises(ValueError, match="tile"):
        stage(*ta, tcam, config=TRaster(k_cap=K, tile_h=th, tile_w=tw))
    st = stage(*ta, tcam, config=TRaster(k_cap=K, tile_h=th, tile_w=tw,
                                         backend="dense"))
    assert st.grid.tile_h == th and st.grid.tile_w == tw


def test_plain_k2_on_some_tiles_is_the_full_walk_there():
    _, tcam, arrays = _scene()
    st = stage(*[_t(a) for a in arrays], tcam,
               config=TRaster(k_cap=K, payload_dtype="f32", tile_h=32,
                              tile_w=32, forward_only=True))
    g = st.grid
    args = (st.payload_f32, st.payload_aux, st.binned.tile_starts)
    out = blend_cuda.blend(*args, g, g.padded_height, g.padded_width)
    dout = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(out.shape)).astype(np.float32))
    full = blend_cuda.blend_bwd_ref_tiles(*args, out, dout, g)
    tiles = [1, 2, 5]
    part = blend_cuda.blend_bwd_ref_tiles(*args, out, dout, g, tiles=tiles)
    ts = st.binned.tile_starts.tolist()
    mask = torch.zeros(full[0].shape[1], dtype=torch.bool)
    for t in tiles:
        mask[ts[t]:ts[t + 1]] = True
    assert int(mask.sum()) > 0
    for a, b in zip(part, full):
        assert torch.equal(a[:, mask], b[:, mask])
        assert not a[:, ~mask].any()
