"""Blend backward of the port against vegs_tpu and against autograd.

`blend_bwd` on CPU tensors runs `blend_bwd_ref_tiles`, the plain version of
kernel K2. It is held against the JAX Pallas backward `_blend_bwd_impl`
(interpret mode) fed the same payloads, forward output and cotangent, in
f32 and bf16 aux; and against torch autograd of the port's dense spec
(`blend_ref.blend_dense`).

Tolerance, per gradient row r: |port - ref| <= 1e-4 * max_r |ref| (+ one
bf16 ulp, 2^-7 |ref|, for the bf16 aux rows, which both sides round from
float32 values that differ in the last bits). The Pallas kernel forms the
splat exponent from pixel monomials, prefix-sums log T and the w dw terms
with triangular matmuls and reduces over pixels with matmuls; the plain
version evaluates the spec's exponent and sums in another order, so the
rows differ by float32 rounding (measured: <= 6e-5 of the row maximum).
The inputs are checked to have no stop flip (the forward outputs agree).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.utils import make_camera, random_gaussians
from vegs_tpu import geometry as jgeo
from vegs_tpu.ops import binning as jbin, blend_pallas
from vegs_tpu.ops.projection import project as jproject
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import binning as tbin, blend_cuda, blend_ref as tref
from vegs_torch.ops.rasterize import RasterizeConfig, stage

H, W = 32, 128
ROW_RTOL = 1e-4
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _payloads(aux_dtype, n=400, seed=0, k_cap=1 << 13):
    """JAX-side projection, binning and payload gather."""
    rng = np.random.default_rng(seed)
    cam = make_camera(height=H, width=W)
    means, quats, scales, opac, shs = random_gaussians(rng, n)
    proj = jproject(means, jgeo.cov6_from_scaling_rotation(scales, quats),
                    opac, shs, cam)
    grid = jbin.TileGrid.for_image(H, W)
    binned = jbin.bin_gaussians(proj.means2d, proj.depths, proj.radii_xy,
                                grid, k_cap, conics=proj.conics,
                                opacities=proj.opacities, want_grad_maps=False)
    assert int(binned.num_dropped) == 0
    quat_n = jgeo.quat_standardize(jgeo.quat_normalize(quats))
    pay_f32 = jnp.concatenate(
        [proj.means2d.T, proj.conics.T, proj.opacities[None],
         proj.depths[None], jnp.zeros((1, n))], axis=0)
    pay_aux = jnp.concatenate(
        [proj.rgb.T, quat_n.T, scales.T, jnp.zeros((6, n))], axis=0
    ).astype(aux_dtype)
    pf = jnp.pad(pay_f32, ((0, 0), (0, 1)))[:, binned.gidx]
    pa = jnp.pad(pay_aux, ((0, 0), (0, 1)))[:, binned.gidx]
    return grid, binned, pf, pa


def _to_torch_aux(pa):
    if pa.dtype == jnp.bfloat16:
        return _t(pa.astype(jnp.float32)).to(torch.bfloat16)
    return _t(pa)


def _assert_rows_close(port, ref, bf16=False):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    tol = ROW_RTOL * np.abs(ref).max(axis=1, keepdims=True)
    if bf16:
        tol = tol + BF16_ULP * np.abs(ref)
    bad = np.abs(port - ref) > tol
    assert not bad.any(), (
        f"{int(bad.sum())} gradients outside tolerance, rows "
        f"{sorted(set(np.nonzero(bad)[0].tolist()))}")


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_blend_bwd_plain_matches_pallas(aux):
    aux_dtype = jnp.float32 if aux == "f32" else jnp.bfloat16
    grid, binned, pf, pa = _payloads(aux_dtype)
    hp, wp = grid.padded_height, grid.padded_width
    out = blend_pallas._blend_fwd_impl(pf, pa, binned.tile_starts, grid, hp,
                                       wp, chunk=256)
    dout = jnp.asarray(np.random.default_rng(10).normal(
        size=out.shape).astype(np.float32))
    jpf, jpa = blend_pallas._blend_bwd_impl(pf, pa, binned.tile_starts, out,
                                            dout, grid, chunk=256)
    tgrid = tbin.TileGrid(*grid)
    pa_t = _to_torch_aux(pa)
    port_out = blend_cuda.blend(_t(pf), pa_t, _t(binned.tile_starts), tgrid,
                                hp, wp)
    # no stop flip: both forwards agree everywhere
    np.testing.assert_allclose(port_out.numpy(), np.asarray(out), rtol=1e-4,
                               atol=1e-4)
    tpf, tpa = blend_cuda.blend_bwd(_t(pf), pa_t, _t(binned.tile_starts),
                                    _t(out), _t(dout), tgrid)
    assert tpf.dtype == torch.float32 and tpa.dtype == pa_t.dtype
    assert tuple(tpf.shape) == (8, pf.shape[1])
    assert tuple(tpa.shape) == (16, pf.shape[1])
    _assert_rows_close(tpf.numpy(), jpf)
    _assert_rows_close(tpa.float().numpy(), jpa.astype(jnp.float32),
                       bf16=(aux == "bf16"))
    # rows past the payload (pad) and slots past tile_starts[-1] are zero
    assert not tpf[7].any() and not tpa[10:].float().any()
    live = int(binned.tile_starts[-1])
    assert not tpf[:, live:].any() and not tpa[:, live:].float().any()
    assert int((tpf[5] != 0).sum()) > 100  # real gradients


def test_blend_bwd_plain_matches_dense_autograd():
    """K2's plain version equals autograd of the dense spec (f32), on a
    scene projected and binned by the port itself."""
    cam = make_camera(height=16, width=W)
    rng = np.random.default_rng(3)
    arrays = [_t(x) for x in random_gaussians(rng, 120)]
    tcam = camera_params_from_numpy(cam.viewmatrix, cam.projmatrix,
                                    cam.campos, cam.tan_fovx, cam.tan_fovy,
                                    16, W, device="cpu")
    st = stage(*arrays, tcam, config=RasterizeConfig(
        k_cap=2048, backend="dense", payload_dtype="f32", forward_only=True))
    tgrid = st.grid
    hp, wp = tgrid.padded_height, tgrid.padded_width
    pf_t, pa_t, ts = st.payload_f32, st.payload_aux, st.binned.tile_starts
    payload = torch.cat([pf_t[:6], pa_t[0:3], pf_t[6:7], pa_t[3:10]]
                        ).requires_grad_(True)
    out = tref.blend_dense(payload, st.binned.sort_keys, ts, tgrid, hp, wp)
    dout = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(out.shape)).astype(np.float32))
    (out * dout).sum().backward()
    g = payload.grad.numpy()
    ref_pf = np.concatenate([g[:6], g[9:10], np.zeros((1, g.shape[1]))])
    ref_pa = np.concatenate([g[6:9], g[10:17], np.zeros((6, g.shape[1]))])
    tpf, tpa = blend_cuda.blend_bwd(pf_t, pa_t, ts, out.detach(), dout, tgrid)
    assert int((tpf[5] != 0).sum()) > 50
    _assert_rows_close(tpf.numpy(), ref_pf)
    _assert_rows_close(tpa.numpy(), ref_pa)


def test_blend_autograd_function_on_cpu():
    """`BlendFn` gives the plain K2 gradients through autograd, from the
    padded output and a padded cotangent that is zero outside the image."""
    grid, binned, pf, pa = _payloads(jnp.float32, seed=5)
    hp, wp = grid.padded_height, grid.padded_width
    tgrid = tbin.TileGrid(*grid)
    pf_t = _t(pf).requires_grad_(True)
    pa_t = _t(pa).requires_grad_(True)
    ts = _t(binned.tile_starts)
    out = blend_cuda.BlendFn.apply(pf_t, pa_t, ts, tgrid, hp, wp)
    h = H - 5  # the image is smaller than the padded grid
    w_img = torch.from_numpy(np.random.default_rng(6).normal(
        size=(12, h, W)).astype(np.float32))
    (out[:, :h, :W] * w_img).sum().backward()
    dout = torch.zeros((12, hp, wp))
    dout[:, :h, :W] = w_img
    rpf, rpa = blend_cuda.blend_bwd(pf_t.detach(), pa_t.detach(), ts,
                                    out.detach(), dout, tgrid)
    assert torch.equal(pf_t.grad, rpf) and torch.equal(pa_t.grad, rpa)
    with pytest.raises(ValueError, match="dout"):
        blend_cuda.blend_bwd(pf_t.detach(), pa_t.detach(), ts, out.detach(),
                             dout[:, :h], tgrid)


def test_plain_versions_float64_and_tile_subset():
    """The plain versions' yardstick options: computing in float64 stays
    within float32 rounding of the float32 walk (forward 1e-4, gradients
    1e-4 of the row's max), and walking a subset of the tiles gives those
    tiles' outputs and gradients unchanged and leaves the rest empty."""
    grid, binned, pf, pa = _payloads(jnp.float32, seed=7)
    hp, wp = grid.padded_height, grid.padded_width
    tgrid = tbin.TileGrid(*grid)
    args = (_t(pf), _t(pa), _t(binned.tile_starts))
    out32, stop32 = blend_cuda.blend_ref_tiles(*args, tgrid, hp, wp,
                                               return_stop=True)
    out64, stop64 = blend_cuda.blend_ref_tiles(*args, tgrid, hp, wp,
                                               return_stop=True,
                                               dtype=torch.float64)
    assert out64.dtype == torch.float64 and torch.equal(stop32, stop64)
    np.testing.assert_allclose(out64.numpy(), out32.numpy(), rtol=1e-4,
                               atol=1e-4)
    dout = torch.from_numpy(np.random.default_rng(8).normal(
        size=tuple(out32.shape)).astype(np.float32))
    g32 = blend_cuda.blend_bwd_ref_tiles(*args, out32, dout, tgrid)
    g64 = blend_cuda.blend_bwd_ref_tiles(*args, out32, dout, tgrid,
                                         dtype=torch.float64)
    assert all(g.dtype == torch.float64 for g in g64)
    for a, b in zip(g32, g64):
        _assert_rows_close(a.numpy(), b.numpy())
    starts = binned.tile_starts.tolist()
    tiles = [t for t in range(tgrid.num_tiles) if starts[t + 1] > starts[t]][1::2]
    sub = blend_cuda.blend_ref_tiles(*args, tgrid, hp, wp, tiles=tiles)
    gsub = blend_cuda.blend_bwd_ref_tiles(*args, out32, dout, tgrid,
                                          tiles=tiles)
    inside = torch.zeros(pf.shape[1], dtype=torch.bool)
    for t in tiles:
        oy, ox = (t // tgrid.ntx) * 16, (t % tgrid.ntx) * 16
        assert torch.equal(sub[:, oy:oy + 16, ox:ox + 16],
                           out32[:, oy:oy + 16, ox:ox + 16])
        inside[starts[t]:starts[t + 1]] = True
    for a, b in zip(gsub, g32):
        assert torch.equal(a[:, inside], b[:, inside])
        assert not a[:, ~inside].any()
    assert int((g32[0][5][inside] != 0).sum()) > 20
