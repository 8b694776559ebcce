"""vegs_torch projection and binning against vegs_tpu.

Projection: every Projected field; floats at rtol 1e-5 / atol 1e-4 (same
float32 expressions, evaluated op by op in torch and fused by XLA), integer
radii equal on >= 99.9% of entries and otherwise off by one (a ceil of a
value that rounds across an integer).

Binning is fed the JAX-projected arrays, so any difference is the port's:
raw_starts, tile_starts, total, num_real and num_dropped must be EXACT, the
packed keys too, and gidx is compared as a multiset within each run of
equal keys (the JAX sort is unstable, so tie order is not part of the
contract).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.utils import make_camera, random_gaussians
from vegs_tpu import geometry as jgeo
from vegs_tpu.ops import binning as jbin
from vegs_tpu.ops.projection import project as jproject
from vegs_torch import geometry as tgeo
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import binning as tbin
from vegs_torch.ops.projection import project as tproject

H, W = 64, 128
K_CAP = 1 << 14


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed=0, n=1500):
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, shs = random_gaussians(
        rng, n, depth_range=(0.1, 9.0), xy_extent=3.0,
        scale_range=(0.01, 0.4), opacity_range=(0.002, 0.99))
    valid = rng.uniform(size=n) > 0.05
    cam = make_camera(height=H, width=W, fovx=1.1, fovy=0.7)
    return cam, (means, quats, scales, opac, shs), valid


def _jax_projected(seed=0):
    cam, (means, quats, scales, opac, shs), valid = _scene(seed)
    cov6 = jgeo.cov6_from_scaling_rotation(scales, quats)
    return jproject(means, cov6, opac, shs, cam, valid=jnp.asarray(valid))


def test_project_matches_jax():
    cam, (means, quats, scales, opac, shs), valid = _scene()
    tcam = camera_params_from_numpy(cam.viewmatrix, cam.projmatrix, cam.campos,
                                    cam.tan_fovx, cam.tan_fovy, H, W,
                                    device="cpu")
    for deg in (0, 3):
        pj = jproject(means, jgeo.cov6_from_scaling_rotation(scales, quats),
                      opac, shs, cam, sh_degree=deg, valid=jnp.asarray(valid))
        pt = tproject(_t(means), tgeo.cov6_from_scaling_rotation(_t(scales), _t(quats)),
                      _t(opac), _t(shs), tcam, sh_degree=deg,
                      valid=_t(valid))
        for name in pj._fields:
            a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype == np.int32:
                diff = np.abs(a.astype(np.int64) - b)
                assert diff.max() <= 1, name
                assert (diff == 0).mean() >= 0.999, (name, int((diff > 0).sum()))
            elif a.dtype == np.bool_:
                assert (a == b).mean() >= 0.999, name
            else:
                ok = np.isfinite(a)
                np.testing.assert_allclose(b[ok], a[ok], rtol=1e-5, atol=1e-4,
                                           err_msg=name)
        assert int(np.asarray(pj.radii > 0).sum()) > 500  # real coverage


def _multiset_equal(keys, gidx_a, gidx_b):
    run = np.concatenate([[0], np.cumsum(keys[1:] != keys[:-1])])
    oa = np.lexsort((gidx_a, run))
    ob = np.lexsort((gidx_b, run))
    np.testing.assert_array_equal(gidx_a[oa], gidx_b[ob])


@pytest.mark.parametrize("compact", [True, False, None],
                         ids=["compact", "posthoc", "auto"])
@pytest.mark.parametrize("override", [False, True], ids=["full", "clipped"])
def test_binning_exact(compact, override):
    pj = _jax_projected()
    n = pj.means2d.shape[0]
    jgrid = jbin.TileGrid.for_image(H, W)
    tgrid = tbin.TileGrid.for_image(H, W)
    assert tuple(jgrid) == tuple(tgrid)
    args_j = (pj.means2d, pj.depths, pj.radii_xy, jgrid, K_CAP)
    args_t = (_t(pj.means2d), _t(pj.depths), _t(pj.radii_xy), tgrid, K_CAP)
    kw_j = dict(conics=pj.conics, opacities=pj.opacities, compact=compact)
    kw_t = dict(conics=_t(pj.conics), opacities=_t(pj.opacities),
                compact=compact)

    rj = jbin.bin_raw(*args_j, **kw_j)
    rt = tbin.bin_raw(*args_t, **kw_t)
    for name in ("raw_starts", "num_real", "total", "num_raw", "cum",
                 "key_sorted"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    _multiset_equal(np.asarray(rj.key_sorted), np.asarray(rj.gidx_sorted),
                    rt.gidx_sorted.numpy())

    sat = None
    if override:
        raw = np.diff(np.asarray(rj.raw_starts))
        sat = np.random.default_rng(1).integers(0, raw + 1).astype(np.int32)
    bj = jbin.bin_gaussians(*args_j, **kw_j, want_grad_maps=False, rb=rj,
                            k_pad=K_CAP // 2,
                            sat_counts=None if sat is None else jnp.asarray(sat))
    bt = tbin.bin_gaussians(*args_t, **kw_t, rb=rt, k_pad=K_CAP // 2,
                            sat_counts=None if sat is None else _t(sat))
    for name in ("tile_starts", "num_instances", "num_dropped", "sort_keys",
                 "gauss_ends"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)),
                                      err_msg=name)
    _multiset_equal(np.asarray(bj.sort_keys), np.asarray(bj.gidx),
                    bt.gidx.numpy())
    assert int(bt.num_instances) > 1000
    assert np.asarray(bt.gidx).max() == n  # padding points at the dummy row


def test_binning_drops_at_small_capacity():
    """Overflow drops from the tail and num_dropped counts it, exactly as
    the JAX package does."""
    pj = _jax_projected(seed=2)
    grid = jbin.TileGrid.for_image(H, W)
    bj = jbin.bin_gaussians(pj.means2d, pj.depths, pj.radii_xy, grid, 4096,
                            conics=pj.conics, opacities=pj.opacities,
                            want_grad_maps=False)
    bt = tbin.bin_gaussians(_t(pj.means2d), _t(pj.depths), _t(pj.radii_xy),
                            tbin.TileGrid(*grid), 4096, conics=_t(pj.conics),
                            opacities=_t(pj.opacities))
    assert int(bj.num_dropped) > 0
    assert int(bt.num_dropped) == int(bj.num_dropped)
    np.testing.assert_array_equal(bt.tile_starts.numpy(),
                                  np.asarray(bj.tile_starts))


def test_depth_key_and_tile_rects():
    rng = np.random.default_rng(3)
    d = rng.uniform(0.01, 500.0, 1000).astype(np.float32)
    for s in (19, 12):
        np.testing.assert_array_equal(
            tbin.depth_key(_t(d), s).numpy(), np.asarray(jbin.depth_key(jnp.asarray(d), s)))
    m2d = rng.uniform(-40, 170, (500, 2)).astype(np.float32)
    radii = rng.integers(0, 30, (500, 2)).astype(np.int32)
    grid = jbin.TileGrid.for_image(H, W)
    for r in (radii, radii[:, 0]):
        for a, b in zip(tbin.tile_rects(_t(m2d), _t(r), tbin.TileGrid(*grid)),
                        jbin.tile_rects(jnp.asarray(m2d), jnp.asarray(r), grid)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grad_maps_not_ported_yet():
    """The grad maps are ported now (exact parity with tie-free keys is in
    tests/test_torch_rasterize_grad.py); here, on a scene whose keys tie,
    their invariants: each raw row lands on a padded slot of its own
    Gaussian, every padded instance has exactly one row, and the rows of
    Gaussian g end at gauss_ends[g]."""
    pj = _jax_projected()
    b = tbin.bin_gaussians(_t(pj.means2d), _t(pj.depths), _t(pj.radii_xy),
                           tbin.TileGrid.for_image(H, W), K_CAP,
                           conics=_t(pj.conics), opacities=_t(pj.opacities),
                           want_grad_maps=True)
    order = b.order.numpy()
    live = order < K_CAP
    assert int(live.sum()) == int(b.num_instances) > 1000
    row_g = np.searchsorted(b.gauss_ends.numpy(), np.arange(len(order)),
                            side="right")
    np.testing.assert_array_equal(b.gidx.numpy()[order[live]], row_g[live])
    assert len(np.unique(order[live])) == int(live.sum())
