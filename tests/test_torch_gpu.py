"""Kernels of the port on a CUDA card against their plain PyTorch versions.

Marked `gpu`: without a card every test here skips (the decision is made in
a fixture, at run time). Run on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances as in chip_smoke.py: K4 counts equal (a tile may differ by
exactly one 256-slot window); K1 |d| <= 1e-5 + 1e-4 |ref| outside pixels
whose stop index differs, those at most 0.1% of the pixels; K2 and K3 and
the training step's gradients as stated in their tests, each limit set
from the readings on an H100 (PERF.md); M2 bit-identical to its plain
version; M1 within 1e-8 of the sum of |x|.

The card's machine has no JAX, and tests/conftest.py imports it, so run
this file there with `--noconftest`.
"""

import numpy as np
import pytest
import torch

from vegs_torch import geometry
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import blend_cuda, satcull
from vegs_torch.ops.rasterize import RasterizeConfig, rasterize, stage

pytestmark = pytest.mark.gpu

H, W = 64, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(device, n=4000, seed=0, scale_range=(0.05, 0.4),
           opacity_range=(0.3, 0.99)):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                      rng.uniform(1.5, 10.0, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    opac = rng.uniform(*opacity_range, n).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    view = geometry.world_to_view(np.eye(3), np.zeros(3))
    full = geometry.projection_matrix(0.01, 100.0, 1.0, 0.4) @ view
    cam = camera_params_from_numpy(view.T, full.T, np.zeros(3), np.tan(0.5),
                                   np.tan(0.2), H, W, device=device)
    arrays = [torch.from_numpy(x).to(device)
              for x in (means, quats, scales, opac, shs)]
    return arrays, cam


CFG = RasterizeConfig(k_cap=1 << 20, k_pad=1 << 20, forward_only=True,
                      sat_cull=True)


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_blend_kernel_matches_plain(cuda, aux):
    arrays, cam = _scene(cuda)
    st = stage(*arrays, cam, config=CFG._replace(payload_dtype=aux))
    g = st.grid
    args = (st.payload_f32, st.payload_aux, st.binned.tile_starts, g,
            g.padded_height, g.padded_width)
    out, stop = blend_cuda.blend(*args, return_stop=True)
    ref, stop_ref = blend_cuda.blend_ref_tiles(*args, return_stop=True)
    torch.cuda.synchronize()
    flips = stop != stop_ref
    bad = ((out - ref).abs() > 1e-5 + 1e-4 * ref.abs()).any(dim=0) & ~flips
    assert int(bad.sum()) == 0
    assert int(flips.sum()) <= 1e-3 * flips.numel()
    assert float(ref[11].min()) < 1e-2  # pixels do stop


def test_satcount_kernel_matches_plain(cuda):
    arrays, cam = _scene(cuda, scale_range=(0.1, 0.6))
    st = stage(*arrays, cam, config=CFG)
    k = satcull.satcount(st.pf_sorted, st.rb.raw_starts, st.grid)
    ref = satcull.satcount_ref(st.pf_sorted, st.rb.raw_starts, st.grid)
    d = (k.long() - ref.long()).abs()
    assert bool(((d == 0) | (d == 256)).all())
    assert int(k.sum()) < int(st.rb.num_real)  # the scene saturates


def test_satcull_bit_identical_on_card(cuda):
    arrays, cam = _scene(cuda, scale_range=(0.1, 0.6))
    on = rasterize(*arrays, cam, config=CFG)
    off = rasterize(*arrays, cam, config=CFG._replace(sat_cull=False))
    assert int(on.num_needed) < int(off.num_needed)
    for name in ("rgb", "depth", "alpha", "cov_quat", "cov_scale"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name


def test_cuda_tensors_never_reach_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(blend_cuda, "blend_ref_tiles", refuse)
    monkeypatch.setattr(satcull, "satcount_ref", refuse)
    arrays, cam = _scene(cuda)
    b0, s0 = blend_cuda.blend.launches, satcull.satcount.launches
    out = rasterize(*arrays, cam, config=CFG)
    torch.cuda.synchronize()
    assert blend_cuda.blend.launches == b0 + 1
    assert satcull.satcount.launches == s0 + 1
    assert torch.isfinite(out.rgb).all()


def test_card_render_matches_cpu_render(cuda):
    arrays, cam = _scene(cuda, n=1500)
    arrays_cpu, cam_cpu = _scene(torch.device("cpu"), n=1500)
    cfg = CFG._replace(k_cap=1 << 16, k_pad=1 << 16)
    g = rasterize(*arrays, cam, config=cfg)
    c = rasterize(*arrays_cpu, cam_cpu, config=cfg)
    d = (g.rgb.cpu() - c.rgb).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.999
    assert int(g.num_dropped) == 0


def _flip_tiles(stop, ref_stop, grid):
    """Tiles holding a pixel whose stop index differs between K1 and its
    plain version (a knife-edge T*(1-alpha) ~ 1e-4 crossing)."""
    f = (stop != ref_stop).reshape(grid.nty, grid.tile_h, grid.ntx, grid.tile_w)
    return f.any(dim=3).any(dim=1).reshape(-1)


K2_RTOL = 1e-4       # K2 against its plain version (see its test)
GRAD_RTOL = 1e-4     # one step's gradients, relative L2 per leaf
CONTROL_ERR = 0.01   # the K2 control's error on the deep instances


def _deep_and_groups(ts, k, grid):
    """Per slot: its tile, whether it lies after its tile's first 256
    instances, and its group (the 256-instance batch of its tile it is
    staged in)."""
    slot = torch.arange(k, device=ts.device)
    tile = torch.searchsorted(ts[1:].long(), slot, right=True).clamp(
        max=grid.num_tiles - 1)
    batch = (slot - ts.long()[tile]) // 256
    group = torch.unique(tile * (batch.max() + 1) + batch,
                         return_inverse=True)[1]
    return tile, batch > 0, group


def _k2_readings(k, r, group, keep, ulp):
    """The largest |k - r| (less ulp |r|) on the slots in `keep`, over the
    largest |r| of the row ("row") and of the slot's group ("group"; inf
    where a group's plain gradients are all zero and the kernel's are
    not)."""
    d = ((k - r).abs() - ulp * r.abs()).clamp(min=0) * keep[None, :]
    ng = int(group.max()) + 1
    idx = group[None, :].expand(r.shape[0], -1)
    gr = r.new_zeros(r.shape[0], ng).scatter_reduce_(1, idx, r.abs(), "amax")
    gd = r.new_zeros(r.shape[0], ng).scatter_reduce_(1, idx, d, "amax")
    by_group = torch.where(gr > 0, gd / gr.clamp(min=1e-30),
                           torch.where(gd > 0, float("inf"), 0.0))
    by_row = d.amax(dim=1) / r.abs().amax(dim=1).clamp(min=1e-30)
    return {"row": float(by_row.max()), "group": float(by_group.max())}


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_blend_bwd_kernel_matches_plain(cuda, aux):
    """K2 against its plain version, on the instances of tiles without a
    stop flip: |d| <= 1e-4 of the largest |plain| of the f32 row, and on
    the aux rows of the largest |plain| of the row in the instance's group
    (the 256-instance batch of its tile), plus one bf16 ulp of the plain
    value on bf16 rows. The f32 rows are not held per group: their low-T
    instances cancel in f32 (dL = tail - cum), in the kernel and the plain
    version alike. The control -- the kernel's output 1% off on the
    instances after each tile's first 256 -- must fail both limits. The
    scene is translucent enough that those deep instances carry gradient,
    and some pixels still stop."""
    arrays, cam = _scene(cuda, opacity_range=(0.02, 0.2))
    st = stage(*arrays, cam, config=CFG._replace(payload_dtype=aux))
    g = st.grid
    ts = st.binned.tile_starts
    args = (st.payload_f32, st.payload_aux, ts)
    out, stop = blend_cuda.blend(*args, g, g.padded_height, g.padded_width,
                                 return_stop=True)
    _, ref_stop = blend_cuda.blend_ref_tiles(*args, g, g.padded_height,
                                             g.padded_width, return_stop=True)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(0),
                       device=cuda)
    n0 = blend_cuda.blend_bwd.launches
    kpf, kpa = blend_cuda.blend_bwd(*args, out, dout, g)
    assert blend_cuda.blend_bwd.launches == n0 + 1
    rpf, rpa = blend_cuda.blend_bwd_ref_tiles(*args, out, dout, g)
    torch.cuda.synchronize()
    flips = _flip_tiles(stop, ref_stop, g)
    assert int(flips.sum()) <= 0.01 * g.num_tiles
    tile, deep, group = _deep_and_groups(ts, kpf.shape[1], g)
    keep = ~flips[tile]
    assert int((deep & (rpf != 0).any(dim=0)).sum()) > 1000
    assert float(out[11].min()) < 1e-3  # pixels do stop
    ctl = 1.0 + CONTROL_ERR * deep.float()
    ulp = 2.0 ** -7 if aux == "bf16" else 0.0
    got = {}
    for rows, k, r, u in (("f32", kpf, rpf, 0.0), ("aux", kpa, rpa, ulp)):
        k_ctl = (k.float() * ctl).to(k.dtype).float()
        got[rows] = (_k2_readings(k.float(), r.float(), group, keep, u),
                     _k2_readings(k_ctl, r.float(), group, keep, u))
    print(f"K2 readings, {aux} aux (sound, control): {got}")
    for rows, scale in (("f32", "row"), ("aux", "group")):
        sound, control = got[rows]
        assert sound[scale] <= K2_RTOL < control[scale], (rows, got)
    assert int((kpf[5] != 0).sum()) > 1000


def test_segreduce_kernel_matches_plain(cuda):
    """K3 sums each segment in column order in float32, as the plain
    version does on the CPU: bit-identical to it."""
    rng = np.random.default_rng(1)
    lens = rng.poisson(1.3, 300_000) * (rng.random(300_000) > 0.2)
    ends = torch.from_numpy(np.cumsum(lens).astype(np.int32))
    starts = torch.cat([torch.zeros(1, dtype=torch.int32), ends[:-1]])
    cols = torch.from_numpy(rng.normal(size=(24, int(ends[-1]) + 77)
                                       ).astype(np.float32))
    from vegs_torch.ops import segreduce

    n0 = segreduce.segment_reduce_cols.launches
    got = segreduce.segment_reduce_cols(cols.to(cuda), starts.to(cuda),
                                        ends.to(cuda))
    assert segreduce.segment_reduce_cols.launches == n0 + 1
    assert torch.equal(got.cpu(), segreduce.segment_reduce_ref(cols, starts, ends))


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_train_step_grads_kernels_match_plain(cuda, aux):
    """One training step's gradients (every field leaf and the means2d tap)
    through the kernels on the card against the plain versions on the CPU:
    relative L2 error <= 1e-4 per leaf."""
    from vegs_torch import convert
    from vegs_torch.config import VegsConfig
    from vegs_torch.train import loss_fn

    rng = np.random.default_rng(2)
    n = 3000
    z = rng.uniform(1.5, 10.0, n)
    arrays = {
        "means": np.stack([rng.uniform(-0.45, 0.45, n) * z,
                           rng.uniform(-0.18, 0.18, n) * z, z], 1),
        "quats": rng.normal(size=(n, 4)),
        "log_scales": np.log(rng.uniform(0.02, 0.3, (n, 3))),
        "sh_dc": rng.normal(0, 0.5, (n, 1, 3)),
        "sh_rest": rng.normal(0, 0.1, (n, 15, 3)),
        "opacity_logit": rng.normal(0, 1.5, (n, 1)),
        "valid": np.ones(n, bool),
    }
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    normal = rng.normal(size=(3, H, W)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        field = convert.field_from_numpy(arrays, device=dev)
        _, cam = _scene(dev, n=10)
        tap = torch.zeros((n, 2), device=dev, requires_grad=True)
        loss, *_ = loss_fn(field, tap, cam, torch.from_numpy(gt).to(dev),
                           torch.from_numpy(normal).to(dev), 1.0, 3,
                           torch.zeros(3, device=dev),
                           opt_cfg=VegsConfig().opt,
                           raster_cfg=CFG._replace(forward_only=False,
                                                   payload_dtype=aux))
        loss.backward()
        grads[dev.type] = {k: getattr(field, k).grad.cpu()
                           for k in convert.FIELD_KEYS[:-1]}
        grads[dev.type]["means2d"] = tap.grad.cpu()
    for k, ref in grads["cpu"].items():
        err = float((grads["cuda"][k] - ref).norm() / ref.norm())
        print(f"step gradient {aux} {k}: {err}")
        assert ref.norm() > 0 and err <= GRAD_RTOL, (k, err)


def test_ssim_means_grad_rms_stable_across_resolution(cuda):
    """The SSIM filters run without TF32 on the card, so the loss
    gradient does not blow up with the image size: the rms of the means
    gradient of (0.8 L1 + 0.2 (1 - SSIM)) at 128x256 stays within 10x of
    its value at 64x128 on the same scene (under TF32 the E[x^2] - mu^2
    noise exceeds c2 and the SSIM gradient explodes, the fault the JAX
    package fixed for bf16 convolutions)."""
    from vegs_torch.losses import l1_loss, ssim

    arrays, _ = _scene(cuda, n=3000)
    view = geometry.world_to_view(np.eye(3), np.zeros(3))
    full = geometry.projection_matrix(0.01, 100.0, 1.0, 0.4) @ view
    rms = []
    for h, w in ((64, 128), (128, 256)):
        cam = camera_params_from_numpy(view.T, full.T, np.zeros(3),
                                       np.tan(0.5), np.tan(0.2), h, w,
                                       device=cuda)
        cfg = RasterizeConfig(k_cap=1 << 20, k_pad=1 << 20)
        with torch.no_grad():
            gt = rasterize(*arrays, cam, config=cfg._replace(
                forward_only=True)).rgb
        means = arrays[0].clone().requires_grad_(True)
        shs = arrays[4].clone()
        shs[:, 0] += 0.3
        out = rasterize(means, *arrays[1:4], shs, cam, config=cfg)
        loss = 0.8 * l1_loss(out.rgb, gt) + 0.2 * (1.0 - ssim(out.rgb, gt))
        loss.backward()
        assert torch.isfinite(means.grad).all()
        rms.append(float(means.grad.square().mean().sqrt()))
    assert rms[0] > 0 and 0.1 < rms[1] / rms[0] < 10.0, rms


M1_RTOL = 1e-8  # M1 against its plain version, of the sum of |x|


def _probe_input(cuda, k, c, dtype, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    return torch.randn((k, c), generator=g, device=cuda).to(dtype)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.bfloat16, 16),
                                     (torch.float32, 3), (torch.bfloat16, 64)])
def test_transpose_kernel_bit_identical(cuda, dtype, c):
    """M2 copies bits: [K, C] -> [C, K] equal to x.t().contiguous()."""
    from vegs_torch.perf import micro3

    x = _probe_input(cuda, 1 << 16, c, dtype)
    n0 = micro3.transpose.launches
    got = micro3.transpose(x)
    assert micro3.transpose.launches == n0 + 1
    bits = torch.int32 if x.element_size() == 4 else torch.int16
    assert torch.equal(got.view(bits), micro3.transpose_ref(x).view(bits))


@pytest.mark.parametrize("layout", ["KC", "CK"])
@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.bfloat16, 16)])
def test_blocksum_kernel_matches_plain(cuda, dtype, c, layout):
    """M1 within 1e-8 of sum|x| of its plain version (the block sums); the
    control -- the last 2^17-long block left out -- outside that limit;
    two runs give the same bits."""
    from vegs_torch.perf import micro3

    x = _probe_input(cuda, 1 << 18, c, dtype, seed=1)
    y = x if layout == "KC" else x.t().contiguous()
    n0 = micro3.psum_consume.launches
    got = micro3.psum_consume(y)
    assert micro3.psum_consume.launches == n0 + 1
    parts = micro3.psum_parts_ref(y)
    ref = float(parts.sum())
    mag = float(y.float().abs().sum())
    reading = abs(float(got) - ref) / mag
    control = abs(float(parts[:-1].sum()) - ref) / mag
    print(f"M1 {dtype} {layout}: reading {reading}, control {control}")
    assert reading <= M1_RTOL < control
    assert torch.equal(got, micro3.psum_consume(y))


def test_probe_kernels_refuse_misaligned_input(cuda):
    from vegs_torch.perf import micro3

    x = torch.zeros((1 << 17) * 8 + 1, device=cuda)[1:].view(1 << 17, 8)
    for fn in (micro3.psum_consume, micro3.transpose):
        with pytest.raises(ValueError, match="aligned"):
            fn(x)
