"""The port's training path through `rasterize` against vegs_tpu.

  * Binning's backward maps: `order` and `gauss_ends` of the port's
    `bin_gaussians(want_grad_maps=True)` equal the JAX package's bit for
    bit, with and without `sat_counts`. The JAX sort is unstable and the
    port's is stable, so exact parity needs keys that are distinct within
    each tile: the scene's depths are stratified and the test asserts it.
  * The gather's backward (`GatherExpand`, kernel K3's plain version) equals
    JAX's `gather_expand` VJP EXACTLY on integer-valued payloads and
    cotangents zeroed on the sat-culled slots (the trick of
    tests/test_satcull.py:90): every per-Gaussian sum is an exact integer,
    so any difference is a mis-mapping, not float noise.
  * The gradients of a weighted sum of every `rasterize` output w.r.t.
    means3d, quats, scales, opacities, shs and the means2d tap equal
    `jax.grad` of the JAX `rasterize` (Pallas backend, interpret mode), with
    the sat cull forced on and off: |port - jax| <= 1e-4 * max |jax| per
    leaf (float32 sums in another order, and the Pallas kernels' monomial
    exponent; measured <= 6e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.utils import make_camera, random_gaussians
from vegs_tpu import geometry as jgeo
from vegs_tpu.ops import binning as jbin, satcull as jsat
from vegs_tpu.ops.projection import project as jproject
from vegs_tpu.ops.rasterize import (RasterizeConfig as JConfig,
                                    gather_expand as jgather,
                                    rasterize as jrasterize)
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import binning as tbin
from vegs_torch.ops.rasterize import (GatherExpand, RasterizeConfig as TConfig,
                                      rasterize as trasterize)

H, W = 32, 128
K = 1 << 13
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


def _scene(seed=0, n=900):
    """The saturating scene of tests/test_satcull.py with stratified,
    shuffled depths, so that no two instances of a tile share a key."""
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, shs = [np.array(x) for x in random_gaussians(
        rng, n, depth_range=(1.5, 10.0), xy_extent=3.0,
        scale_range=(0.1, 0.6), opacity_range=(0.5, 0.99))]
    means[:, 2] = rng.permutation(np.linspace(1.5, 10.0, n)).astype(np.float32)
    cam = make_camera(height=H, width=W, fovx=1.0, fovy=0.3)
    return cam, (means, quats, scales, opac, shs)


def _binned_both(sat: bool):
    cam, (means, quats, scales, opac, shs) = _scene()
    n = means.shape[0]
    proj = jproject(jnp.asarray(means),
                    jgeo.cov6_from_scaling_rotation(jnp.asarray(scales),
                                                    jnp.asarray(quats)),
                    jnp.asarray(opac), jnp.asarray(shs), cam)
    jgrid = jbin.TileGrid.for_image(H, W)
    kw = dict(conics=proj.conics, opacities=proj.opacities)
    rj = jbin.bin_raw(proj.means2d, proj.depths, proj.radii_xy, jgrid, K, **kw)
    keys = np.asarray(rj.key_sorted)[:int(rj.num_real)]
    assert (np.diff(keys) > 0).all(), "keys must be distinct within tiles"
    sat_counts = None
    if sat:
        pay = jnp.concatenate(
            [proj.means2d, proj.conics, proj.opacities[:, None],
             proj.depths[:, None], jnp.zeros((n, 1), jnp.float32)], 1)
        pf_sorted = jnp.pad(pay, ((0, 1), (0, 0)))[rj.gidx_sorted]
        sat_counts = jsat.satcount(pf_sorted.T, rj.raw_starts, jgrid)
    bj = jbin.bin_gaussians(proj.means2d, proj.depths, proj.radii_xy, jgrid,
                            K, **kw, rb=rj, sat_counts=sat_counts)
    tgrid = tbin.TileGrid(*jgrid)
    targs = (_t(proj.means2d), _t(proj.depths), _t(proj.radii_xy), tgrid, K)
    tkw = dict(conics=_t(proj.conics), opacities=_t(proj.opacities))
    rt = tbin.bin_raw(*targs, **tkw)
    bt = tbin.bin_gaussians(*targs, **tkw, rb=rt, want_grad_maps=True,
                            sat_counts=None if sat_counts is None
                            else _t(sat_counts))
    return n, bj, bt, sat_counts


@pytest.mark.parametrize("sat", [False, True], ids=["full", "sat_cull"])
def test_order_and_gauss_ends_exact(sat):
    n, bj, bt, sat_counts = _binned_both(sat)
    for name in ("order", "gauss_ends", "tile_starts", "gidx"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)),
                                      err_msg=name)
    assert bt.order.dtype == torch.int32
    live = bt.order < bt.gidx.shape[0]
    # invariants: row r of `order` lands on a slot holding its Gaussian
    g_of_row = np.searchsorted(bt.gauss_ends.numpy(), np.arange(
        bt.order.shape[0]), side="right")
    np.testing.assert_array_equal(
        bt.gidx.numpy()[bt.order.numpy()[live.numpy()]],
        g_of_row[live.numpy()])
    # every instance of the padded layout has exactly one row
    assert int(live.sum()) == int(bt.num_instances)
    if sat:
        assert int(bt.order.shape[0]) == K  # min(k_pad, k_cap)
        assert int(live.sum()) == int(bt.gauss_ends[-1])  # compact rows


@pytest.mark.parametrize("sat", [False, True], ids=["full", "sat_cull"])
def test_gather_backward_exact_on_integer_cotangents(sat):
    n, bj, bt, sat_counts = _binned_both(sat)
    rng = np.random.default_rng(7)
    pf = rng.integers(-8, 8, size=(n + 1, 8)).astype(np.float32)
    pa = rng.integers(-8, 8, size=(n + 1, 16)).astype(np.float32)
    kp = bt.gidx.shape[0]
    # cotangent weights: live slots inside each tile's kept prefix
    ts = bt.tile_starts.numpy()
    slot = np.arange(kp)
    tile_of = np.clip(np.searchsorted(ts, slot, side="right") - 1, 0,
                      len(ts) - 2)
    keep = bt.gidx.numpy() < n
    if sat:
        keep &= (slot - ts[tile_of]) < np.asarray(sat_counts)[tile_of]
    wf = rng.integers(-4, 4, size=(kp, 8)).astype(np.float32) * keep[:, None]
    wa = rng.integers(-4, 4, size=(kp, 16)).astype(np.float32) * keep[:, None]

    ends_j = jnp.concatenate([bj.gauss_ends, bj.gauss_ends[-1:]])

    def f(a, b):
        x, y = jgather(a, b, bj.gidx, bj.order, ends_j)
        return jnp.sum(x * wf) + jnp.sum(y * wa)

    gj = jax.grad(f, argnums=(0, 1))(jnp.asarray(pf), jnp.asarray(pa))
    a = _t(pf).requires_grad_(True)
    b = _t(pa).requires_grad_(True)
    ends_t = torch.cat([bt.gauss_ends, bt.gauss_ends[-1:]])
    x, y = GatherExpand.apply(a, b, bt.gidx, bt.order, ends_t)
    assert tuple(x.shape) == (8, kp) and tuple(y.shape) == (16, kp)
    ((x.T * _t(wf)).sum() + (y.T * _t(wa)).sum()).backward()
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(gj[0]))
    np.testing.assert_array_equal(b.grad.numpy(), np.asarray(gj[1]))
    assert np.abs(a.grad.numpy()).sum() > 0


@pytest.mark.parametrize("sat", [False, True], ids=["full", "sat_cull"])
def test_rasterize_grads_match_jax(sat):
    cam, arrays = _scene()
    n = arrays[0].shape[0]
    wts = [np.random.default_rng(5).normal(size=s).astype(np.float32)
           for s in ((3, H, W), (1, H, W), (4, H, W), (3, H, W), (1, H, W))]

    def f(m, q, s, o, sh, off):
        out = jrasterize(m, q, s, o, sh, cam, means2d_offset=off,
                         config=JConfig(backend="pallas", k_cap=K,
                                        payload_dtype="f32", sat_cull=sat))
        return sum(jnp.sum(getattr(out, k) * w) for k, w in zip(OUTPUTS, wts))

    gj = jax.grad(f, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in arrays], jnp.zeros((n, 2)))

    tcam = camera_params_from_numpy(cam.viewmatrix, cam.projmatrix, cam.campos,
                                    cam.tan_fovx, cam.tan_fovy, H, W,
                                    device="cpu")
    ta = [_t(a).requires_grad_(True) for a in arrays]
    off = torch.zeros((n, 2), requires_grad=True)
    out = trasterize(*ta, tcam, means2d_offset=off,
                     config=TConfig(k_cap=K, payload_dtype="f32",
                                    sat_cull=sat))
    assert int(out.num_dropped) == 0
    sum((getattr(out, k) * _t(w)).sum() for k, w in zip(OUTPUTS, wts)
        ).backward()
    for name, a, b in zip(LEAVES, ta + [off], gj):
        ref = np.asarray(b)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(a.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
