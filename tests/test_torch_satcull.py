"""Saturation prepass of the port (vegs_torch/ops/satcull.py) against
vegs_tpu: `satcount_ref` (the plain version of kernel K4) must equal both
the JAX Pallas `satcount` (interpret mode) and the JAX loop oracle
`satcount_np` EXACTLY, on the saturating scene of tests/test_satcull.py,
and so must the main path's entry `satcount_gathered`, which reads the
padded payload rows through the sorted Gaussian index; and the port's
render with the cull on must be bit-identical to the same render with it
off (the cull is lossless)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.utils import make_camera, random_gaussians
from vegs_tpu import geometry as jgeo
from vegs_tpu.ops import binning as jbin, satcull as jsat
from vegs_tpu.ops.projection import project as jproject
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import binning as tbin, satcull as tsat
from vegs_torch.ops.rasterize import RasterizeConfig, rasterize

H, W = 32, 128
K = 1 << 13


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed=0, n=900):
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, shs = random_gaussians(
        rng, n, depth_range=(1.5, 10.0), xy_extent=3.0,
        scale_range=(0.1, 0.6), opacity_range=(0.5, 0.99))
    cam = make_camera(height=H, width=W, fovx=1.0, fovy=0.3)
    return cam, means, quats, scales, opac, shs


def test_satcount_ref_matches_jax_kernel_and_oracle():
    cam, means, quats, scales, opac, shs = _scene()
    grid = jbin.TileGrid.for_image(H, W)
    proj = jproject(means, jgeo.cov6_from_scaling_rotation(scales, quats),
                    opac, shs, cam)
    rb = jbin.bin_raw(proj.means2d, proj.depths, proj.radii_xy, grid, K,
                      conics=proj.conics, opacities=proj.opacities)
    n = means.shape[0]
    pay = jnp.concatenate(
        [proj.means2d, proj.conics, proj.opacities[:, None],
         proj.depths[:, None], jnp.zeros((n, 1), jnp.float32)], axis=1)
    pf_sorted = np.array(jnp.pad(pay, ((0, 1), (0, 0)))[rb.gidx_sorted].T)
    starts = np.asarray(rb.raw_starts)
    ref = tsat.satcount(_t(pf_sorted), _t(starts), tbin.TileGrid(*grid)).numpy()
    np.testing.assert_array_equal(
        ref, np.asarray(jsat.satcount(jnp.asarray(pf_sorted), rb.raw_starts, grid)))
    np.testing.assert_array_equal(ref, tsat.satcount_np(pf_sorted, starts, grid))
    np.testing.assert_array_equal(ref, jsat.satcount_np(pf_sorted, starts, grid))
    assert ref.sum() < np.diff(starts).sum(), "scene saturates; cull must bite"
    # the work recorded for the kernel's bound: every pixel walks in-range
    # slots up to its crossing, which lies inside the kept windows
    pairs = {}
    tsat.satcount_ref(_t(pf_sorted), _t(starts), tbin.TileGrid(*grid),
                      pairs=pairs)
    busy = int((np.diff(starts) > 0).sum())
    assert ref.sum() - 256 * busy < pairs["slots"] <= ref.sum()
    assert pairs["walked"] <= 256 * pairs["slots"]
    assert 0 < pairs["included"] < pairs["tested"] <= pairs["walked"]


def test_satcount_gathered_plain_matches_jax_kernel():
    """The main path's K4 entry on the CPU (the plain version of the
    gathered kernel) against the JAX Pallas kernel on the channel-major
    prepass gather jnp.pad(pay)[gidx_sorted].T: equal counts."""
    cam, means, quats, scales, opac, shs = _scene()
    grid = jbin.TileGrid.for_image(H, W)
    proj = jproject(means, jgeo.cov6_from_scaling_rotation(scales, quats),
                    opac, shs, cam)
    rb = jbin.bin_raw(proj.means2d, proj.depths, proj.radii_xy, grid, K,
                      conics=proj.conics, opacities=proj.opacities)
    n = means.shape[0]
    pay = jnp.pad(jnp.concatenate(
        [proj.means2d, proj.conics, proj.opacities[:, None],
         proj.depths[:, None], jnp.zeros((n, 1), jnp.float32)], axis=1),
        ((0, 1), (0, 0)))
    want = np.asarray(jsat.satcount(pay[rb.gidx_sorted].T, rb.raw_starts, grid))
    tgrid = tbin.TileGrid(*grid)
    got = tsat.satcount_gathered(_t(pay), _t(rb.gidx_sorted),
                                 _t(rb.raw_starts), tgrid).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() < np.diff(np.asarray(rb.raw_starts)).sum()
    assert tsat.satcount_gathered.launches == 0  # no kernel on the CPU
    with pytest.raises(ValueError, match=r"\[n \+ 1, 8\]"):
        tsat.satcount_gathered(_t(pay)[:, :6], _t(rb.gidx_sorted),
                               _t(rb.raw_starts), tgrid)


def test_satcount_rejects_unaligned_grid():
    """The JAX wrapper silently assumes ntx % 8 == 0; the port checks."""
    grid = tbin.TileGrid(16, 16, 5, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsat.satcount(torch.zeros((8, 256)), torch.zeros(11, dtype=torch.int32),
                      grid)


@pytest.mark.parametrize("payload_dtype", ["f32", "bf16"])
def test_satcull_render_bit_identical(payload_dtype):
    cam, means, quats, scales, opac, shs = _scene()
    tcam = camera_params_from_numpy(cam.viewmatrix, cam.projmatrix, cam.campos,
                                    cam.tan_fovx, cam.tan_fovy, H, W,
                                    device="cpu")
    args = [_t(x) for x in (means, quats, scales, opac, shs)]
    bg = torch.tensor([0.1, 0.2, 0.3])
    outs = []
    for sat in (True, False):
        cfg = RasterizeConfig(k_cap=K, payload_dtype=payload_dtype,
                              forward_only=True, sat_cull=sat)
        outs.append(rasterize(*args, tcam, bg=bg, config=cfg))
    on, off = outs
    assert int(on.num_dropped) == 0 and int(off.num_dropped) == 0
    assert int(on.num_needed) < int(off.num_needed)
    for name in ("rgb", "depth", "alpha", "cov_quat", "cov_scale"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
