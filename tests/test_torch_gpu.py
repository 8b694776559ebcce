"""Kernels of the port on a CUDA card against their plain PyTorch versions.

Marked `gpu`: without a card every test here skips (the decision is made in
a fixture, at run time). Run on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances as in chip_smoke.py: K4 counts equal (a tile may differ by
exactly one 256-slot window), and equal to the bit between the culled and
unculled builds and between the main path's gathered input and the JAX
layout; K1 |d| <= 1e-5 + 1e-4 |ref| outside pixels
whose stop index differs, those at most 0.1% of the pixels; K2 and K3 and
the training step's gradients as stated in their tests, each limit set
from the readings on an H100 (PERF.md); M2 bit-identical to its plain
version; M1 within 1e-8 of the sum of |x|. The parallel paths (D = 1
under NCCL, D = 2 gloo-host ranks sharing the card; bodies in
tests/torch_parallel_workers.py): the sharded renders equal to the bit to
`rasterize`, one TP step's moments within TP_MU_RTOL of one device's. The tools: the tiny DPT's
crop and one tiny LoRA update, card against CPU, with the limits and
controls stated beside them.

The card's machine has no JAX, and tests/conftest.py imports it, so run
this file there with `--noconftest`.
"""

import numpy as np
import pytest
import torch

from vegs_torch import geometry
from vegs_torch.convert import camera_params_from_numpy
from vegs_torch.ops import blend_cuda, satcull, segreduce
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
    args = (st.pay_rows, st.rb.gidx_sorted, st.rb.raw_starts, st.grid)
    k = satcull.satcount_gathered(*args)
    ref = satcull.satcount_gathered_ref(*args)
    d = (k.long() - ref.long()).abs()
    assert bool(((d == 0) | (d == 256)).all())
    assert int(k.sum()) < int(st.rb.num_real)  # the scene saturates
    assert torch.equal(k, st.sat_counts)


@pytest.mark.parametrize("tiles", [(16, 16), (16, 32)])
def test_satcount_cull_and_layouts_bit_identical(cuda, tiles):
    """K4 with its per-warp cull equals K4 with the cull compiled out, and
    the main path's entry (payload rows read through gidx_sorted) equals
    the JAX layout's (channel-major rows gathered first), count for count,
    on a saturating scene of large splats and on one of smaller splats;
    without the cull the warps walk every in-range pair they consider, and
    on the smaller splats the cull skips some."""
    th, tw = tiles
    for scale_range in ((0.1, 0.6), (0.05, 0.4)):
        arrays, cam = _scene(cuda, scale_range=scale_range)
        st = stage(*arrays, cam, config=CFG._replace(
            payload_dtype="f32", tile_h=th, tile_w=tw))
        args = (st.pay_rows, st.rb.gidx_sorted, st.rb.raw_starts, st.grid)
        n0 = satcull.satcount_gathered.launches
        on, c_on = satcull.satcount_check(*args, cull=True)
        off, c_off = satcull.satcount_check(*args, cull=False)
        assert satcull.satcount_gathered.launches == n0
        main = satcull.satcount_gathered(*args)
        pf_cm = st.pay_rows[st.rb.gidx_sorted.long()].T.contiguous()
        m0 = satcull.satcount.launches
        cm = satcull.satcount(pf_cm, st.rb.raw_starts, st.grid)
        assert satcull.satcount.launches == m0 + 1
        torch.cuda.synchronize()
        print(f"K4 {th}x{tw} scales {scale_range}: kept {int(on.sum())} of "
              f"{int(st.rb.num_real)}, cull {c_on}, no cull {c_off}")
        assert torch.equal(on, off) and torch.equal(main, on)
        assert torch.equal(cm, on)
        assert c_off["walked"] == c_off["warp_instances"] > 0
        assert c_on["warp_instances"] == c_off["warp_instances"]
        if scale_range == (0.1, 0.6):
            assert int(on.sum()) < int(st.rb.num_real)  # the scene saturates
        else:
            assert c_on["skipped_share"] > 0.05


def test_satcount_refuses_misaligned_rows(cuda):
    arrays, cam = _scene(cuda, n=500)
    st = stage(*arrays, cam, config=CFG)
    rows = torch.zeros(st.pay_rows.numel() + 1, device=cuda)[1:].view(-1, 8)
    with pytest.raises(ValueError, match="16-byte"):
        satcull.satcount_gathered(rows, st.rb.gidx_sorted, st.rb.raw_starts,
                                  st.grid)


def test_satcull_bit_identical_on_card(cuda):
    arrays, cam = _scene(cuda, scale_range=(0.1, 0.6))
    on = rasterize(*arrays, cam, config=CFG)
    off = rasterize(*arrays, cam, config=CFG._replace(sat_cull=False))
    assert int(on.num_needed) < int(off.num_needed)
    for name in ("rgb", "depth", "alpha", "cov_quat", "cov_scale"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name


def test_cuda_tensors_never_reach_plain_versions(cuda, monkeypatch):
    """A training-style forward and backward on the card launches K4, K1,
    K2 and K3 once each and never calls a plain version."""
    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    for mod, name in ((blend_cuda, "blend_ref_tiles"),
                      (blend_cuda, "blend_bwd_ref_tiles"),
                      (satcull, "satcount_ref"),
                      (satcull, "satcount_gathered_ref"),
                      (segreduce, "segment_reduce_ref"),
                      (segreduce, "gather_expand_bwd_ref")):
        monkeypatch.setattr(mod, name, refuse)
    arrays, cam = _scene(cuda)
    leaves = [x.clone().requires_grad_(True) for x in arrays]
    counters = (blend_cuda.blend, blend_cuda.blend_bwd,
                satcull.satcount_gathered, segreduce.gather_expand_bwd)
    before = [c.launches for c in counters]
    out = rasterize(*leaves, cam, config=CFG._replace(forward_only=False))
    out.rgb.square().mean().backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    assert torch.isfinite(out.rgb).all()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


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


def _k2_check(cuda, aux, tile):
    """K2 against its plain version at `tile` (see
    test_blend_bwd_kernel_matches_plain). Returns the kernel's dpf, dpa
    and its arguments."""
    th, tw = tile
    arrays, cam = _scene(cuda, opacity_range=(0.02, 0.2))
    st = stage(*arrays, cam, config=CFG._replace(payload_dtype=aux,
                                                 tile_h=th, tile_w=tw))
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
    tile_of, deep, group = _deep_and_groups(ts, kpf.shape[1], g)
    keep = ~flips[tile_of]
    assert int((deep & (rpf != 0).any(dim=0)).sum()) > 1000
    assert float(out[11].min()) < 1e-3  # pixels do stop
    ctl = 1.0 + CONTROL_ERR * deep.float()
    ulp = 2.0 ** -7 if aux == "bf16" else 0.0
    got = {}
    for rows, k, r, u in (("f32", kpf, rpf, 0.0), ("aux", kpa, rpa, ulp)):
        k_ctl = (k.float() * ctl).to(k.dtype).float()
        got[rows] = (_k2_readings(k.float(), r.float(), group, keep, u),
                     _k2_readings(k_ctl, r.float(), group, keep, u))
    print(f"K2 readings, {th}x{tw}, {aux} aux (sound, control): {got}")
    for rows, scale in (("f32", "row"), ("aux", "group")):
        sound, control = got[rows]
        assert sound[scale] <= K2_RTOL < control[scale], (rows, got)
    assert int((kpf[5] != 0).sum()) > 1000
    return kpf, kpa, (*args, out, dout, g)


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
    _k2_check(cuda, aux, (16, 16))


@pytest.mark.parametrize("aux", ["f32", "bf16"])
@pytest.mark.parametrize("tile", [(16, 32), (32, 16), (32, 32)],
                         ids=["16x32", "32x16", "32x32"])
def test_blend_bwd_wide_tiles_match_plain(cuda, tile, aux):
    """K2's 16- and 32-warp builds (tiles of 512 and 1024 pixels) against
    the plain version, under the limits and control of the 16x16 test; and
    two launches on the same inputs equal to the bit (the tile's sums stay
    in one block, in warp order: no atomics)."""
    kpf, kpa, args = _k2_check(cuda, aux, tile)
    again = blend_cuda.blend_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(again[0]), _bits(kpf))
    assert torch.equal(_bits(again[1]), _bits(kpa))


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_blend_cull_bit_identical(cuda, aux):
    """K1 (out, stop) and K2 (dpf, dpa) with the per-warp footprint cull
    equal, to the bit, the same kernels with the cull compiled out, and the
    main path's wrappers give the culled results, at 16x16, 16x32, 32x16
    and 32x32 tiles (K2's 8-, 16- and 32-warp builds). The cull skips
    warp-instance
    pairs even in this scene of large splats; without it the warps walk
    every pair they consider."""
    arrays, cam = _scene(cuda, opacity_range=(0.02, 0.6))
    for th, tw in ((16, 16), (16, 32), (32, 16), (32, 32)):
        st = stage(*arrays, cam, config=CFG._replace(
            payload_dtype=aux, tile_h=th, tile_w=tw))
        g = st.grid
        args = (st.payload_f32, st.payload_aux, st.binned.tile_starts, g)
        hw = (g.padded_height, g.padded_width)
        n0 = blend_cuda.blend.launches
        on, stop_on, c_on = blend_cuda.blend_check(*args, *hw, cull=True)
        off, stop_off, c_off = blend_cuda.blend_check(*args, *hw, cull=False)
        assert blend_cuda.blend.launches == n0
        main, stop = blend_cuda.blend(*args, *hw, return_stop=True)
        torch.cuda.synchronize()
        print(f"K1 {aux} {th}x{tw}: cull {c_on}, no cull {c_off}")
        assert torch.equal(_bits(on), _bits(off))
        assert torch.equal(stop_on, stop_off)
        assert torch.equal(_bits(main), _bits(on)) and torch.equal(stop, stop_on)
        assert c_off["walked"] == c_off["warp_instances"] > 0
        assert c_on["warp_instances"] == c_off["warp_instances"]
        assert c_on["skipped_share"] > 0.05
        dout = torch.randn(on.shape, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
        n0 = blend_cuda.blend_bwd.launches
        pf1, pa1, b_on = blend_cuda.blend_bwd_check(*args[:3], on, dout, g,
                                                    cull=True)
        pf0, pa0, b_off = blend_cuda.blend_bwd_check(*args[:3], on, dout, g,
                                                     cull=False)
        assert blend_cuda.blend_bwd.launches == n0
        mpf, mpa = blend_cuda.blend_bwd(*args[:3], on, dout, g)
        torch.cuda.synchronize()
        print(f"K2 {aux} {th}x{tw}: cull {b_on}, no cull {b_off}")
        for a, b, c in ((pf1, pf0, mpf), (pa1, pa0, mpa)):
            assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(c),
                                                                   _bits(a))
        assert int((pf1[5] != 0).sum()) > 1000
        assert b_off["walked"] == b_off["warp_instances"] > 0
        assert b_on["skipped_share"] > 0.05


def test_satcount_segreduce_occupancy(cuda):
    """The runtime's view of K4 at 16x16 tiles and of K3: no spills, at
    least four K4 blocks and four K3 blocks per SM."""
    infos = {"K4": satcull.kernel_info(256),
             **{f"K3 {dt}": segreduce.kernel_info(dt)
                for dt in (torch.bfloat16, torch.float32)}}
    for name, info in infos.items():
        print(f"{name}: {info}")
        assert info["local_bytes"] == 0 and info["registers"] > 0
        assert info["blocks_per_sm"] >= 4


@pytest.mark.parametrize("lib", ["blend_fwd", "blend_bwd"])
def test_blend_kernel_occupancy(cuda, lib):
    """The runtime's view of K1 and K2 at 16x16 tiles: no spills, three K2
    blocks per SM and four K1 blocks (K1 is built for tiles of up to 1024
    pixels, so for at most 64 registers)."""
    for dtype in (torch.bfloat16, torch.float32):
        info = blend_cuda.kernel_info(lib, dtype, 256)
        print(f"{lib} {dtype}: {info}")
        assert info["local_bytes"] == 0 and info["registers"] > 0
        assert info["blocks_per_sm"] >= (3 if lib == "blend_bwd" else 4)


def test_blend_bwd_wide_builds_occupancy(cuda):
    """The runtime's view of K2's wide builds: the 16-warp one (512-pixel
    tiles) with two blocks per SM, the 32-warp one (1024) with one, each
    held to 64 registers a thread (their spills are printed, not held); a
    tile over 1024 pixels is refused."""
    for pixels, blocks in ((512, 2), (1024, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            info = blend_cuda.kernel_info("blend_bwd", dtype, pixels)
            print(f"blend_bwd {pixels} pixels {dtype}: {info}")
            assert 0 < info["registers"] <= 64
            assert info["blocks_per_sm"] >= blocks
    with pytest.raises(RuntimeError):
        blend_cuda.kernel_info("blend_bwd", torch.float32, 2048)


K3_RTOL = 1e-5  # K3 against its plain version, of the segment's sum of |x|


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_gather_expand_bwd_kernel_matches_plain(cuda, aux):
    """The main path's K3 (the gather's whole backward) against its plain
    version on the CPU: f32 rows within 1e-5 of each segment's sum of |x|
    and equal to the bit on segments a lane sums alone (at most 32 rows,
    segreduce.cu's LONG_ROWS: both add in raw order from 0); aux rows within
    the same plus one bf16 ulp of |ref|. Segment spans from 0 to 300 rows,
    a fifth of the rows dead."""
    rng = np.random.default_rng(5)
    ng, k_pad = 200_000, 1 << 19
    span = rng.poisson(1.3, ng) * (rng.random(ng) > 0.3)
    span[rng.choice(ng, 40, replace=False)] = rng.integers(33, 300, 40)
    ends = torch.from_numpy(np.cumsum(span).astype(np.int32))
    rows = int(ends[-1])
    order = np.where(rng.random(rows + 1000) < 0.2, k_pad,
                     rng.permutation(k_pad)[:rows + 1000]).astype(np.int32)
    order = torch.from_numpy(order)
    dt = torch.float32 if aux == "f32" else torch.bfloat16
    d_pf = torch.from_numpy(rng.normal(size=(8, k_pad)).astype(np.float32))
    d_pa = torch.from_numpy(rng.normal(size=(16, k_pad)).astype(np.float32)
                            ).to(dt)
    n0 = segreduce.gather_expand_bwd.launches
    kf, ka = segreduce.gather_expand_bwd(d_pf.to(cuda), d_pa.to(cuda),
                                         order.to(cuda), ends.to(cuda))
    assert segreduce.gather_expand_bwd.launches == n0 + 1
    assert kf.is_contiguous() and ka.is_contiguous() and ka.dtype == dt
    rf, ra = segreduce.gather_expand_bwd_ref(d_pf, d_pa, order, ends)
    mf, ma = segreduce.gather_expand_bwd_ref(d_pf.abs(), d_pa.abs(), order,
                                             ends)
    ulp = 2.0 ** -7 if aux == "bf16" else 0.0
    for k, r, m, u in ((kf.cpu(), rf, mf, 0.0),
                       (ka.cpu().float(), ra.float(), ma.float(), ulp)):
        d = ((k - r).abs() - u * r.abs()).clamp(min=0)
        reading = float((d / m.clamp(min=1e-30)).max())
        print(f"K3 fused {aux}: reading {reading}")
        assert reading <= K3_RTOL
    short = torch.from_numpy(span <= 32)
    assert torch.equal(kf.cpu()[short], rf[short])
    assert int((~short).sum()) == 40


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


def test_segreduce_jax_contract_at_bench_spans_matches_plain(cuda):
    """K3 under the JAX contract at perf/r05_segreduce2.py's full shape
    (`vegs_torch.perf.gebwd`: [24, 1,126,912] columns, 500,224 segments
    from random sorted ends, the last 223 empty) against its plain version
    on the CPU: within 1e-5 of each segment's sum of |x|, equal to the bit
    on segments of at most 32 columns (both add in column order), the
    empty segments 0; the control -- each segment's last column left out
    -- outside the limit."""
    from vegs_torch.perf import gebwd

    d = gebwd.r05s2_data(cuda)
    cols, starts, ends = d["cols"], d["starts"], d["ends"]
    n0 = segreduce.segment_reduce_cols.launches
    got = segreduce.segment_reduce_cols(cols, starts, ends).cpu()
    assert segreduce.segment_reduce_cols.launches == n0 + 1
    c, s, e = cols.cpu(), starts.cpu(), ends.cpu()
    ref = segreduce.segment_reduce_ref(c, s, e)
    mag = segreduce.segment_reduce_ref(c.abs(), s, e).clamp(min=1e-30)
    short = segreduce.segment_reduce_ref(c, s, torch.maximum(e - 1, s))
    reading = float(((got - ref).abs() / mag).max())
    control = float(((short - ref).abs() / mag).max())
    print(f"K3 JAX contract at r05's spans: reading {reading}, control "
          f"{control}")
    assert reading <= K3_RTOL < control
    span = (e - s).long()
    assert torch.equal(got[:, span <= 32], ref[:, span <= 32])
    assert int((span[gebwd.N5:] == 0).sum()) == gebwd.ng_of(gebwd.N5) - gebwd.N5
    assert not got[:, gebwd.N5:].any()


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


def test_queued_ms_agrees_with_profiler(cuda, monkeypatch):
    """`queued_ms`, the timer `device_profile` falls back to when the
    profiler records nothing, reads M2's device time at K = 2^21 within
    25% of the profiler's (two windows, so some noise), and raises on a
    call that waits on the card; with no profiler window left,
    `device_profile` takes `queued_ms`'s time, or the stream's for such a
    call."""
    from vegs_torch.perf import micro3, timing

    x = _probe_input(cuda, 1 << 21, 8, torch.float32)
    prof = timing.device_profile(lambda: micro3.transpose(x))
    queued = timing.queued_ms(lambda: micro3.transpose(x))
    print(f"M2 profiler {prof['device_ms']} ms, queued {queued} ms")
    assert prof["device_source"] == "profiler"
    assert abs(queued - prof["device_ms"]) <= 0.25 * prof["device_ms"]
    with pytest.raises(timing.HostPaced, match="wait on the card"):
        timing.queued_ms(lambda: float(micro3.transpose(x)[0, 0]))
    monkeypatch.setattr(timing, "PROFILE_TRIES", 0)
    blank = timing.device_profile(lambda: micro3.transpose(x))
    assert blank["device_source"] == "queued_events"
    assert abs(blank["device_ms"] - prof["device_ms"]) <= 0.25 * prof["device_ms"]
    paced = timing.device_profile(lambda: float(micro3.transpose(x)[0, 0]))
    assert paced["device_source"] == "stream_events" and paced["device_ms"] > 0


def test_probe_kernels_refuse_misaligned_input(cuda):
    from vegs_torch.perf import micro3

    x = torch.zeros((1 << 17) * 8 + 1, device=cuda)[1:].view(1 << 17, 8)
    for fn in (micro3.psum_consume, micro3.transpose):
        with pytest.raises(ValueError, match="aligned"):
            fn(x)


def _box_parts(device, seed=4):
    """Two box instances of different capacities (3,000 and 2,000 Gaussians
    on the box's faces, at opacities near a box field's seed, ~0.18, at
    4096 and 8192 rows), small boxes at depths 1.1 and 1.3, in front of
    the static field (whose nearest splats, up to 0.3 across from depth
    1.5, hide what lies behind them), yaw 0.3 and 1.1 rad, residuals a
    little off identity (deltas require grad)."""
    from vegs_torch import convert
    from vegs_torch.boxmodel import BoxDeltas
    from vegs_torch.render import BoxInstance

    rng = np.random.default_rng(seed)
    parts = []
    for (n, cap), yaw, t in zip(((3000, 4096), (2000, 8192)), (0.3, 1.1),
                                ((-0.3, 0.03, 1.1), (0.3, -0.03, 1.3))):
        f = {"means": np.zeros((cap, 3)), "quats": np.zeros((cap, 4)),
             "log_scales": np.full((cap, 3), np.log(1e-7)),
             "sh_dc": np.zeros((cap, 1, 3)), "sh_rest": np.zeros((cap, 15, 3)),
             "opacity_logit": np.zeros((cap, 1)), "valid": np.zeros(cap, bool)}
        p = rng.uniform(-0.5, 0.5, (n, 3))  # on the box's faces
        face = rng.integers(0, 6, n)
        p[np.arange(n), face // 2] = np.where(face % 2, 0.5, -0.5)
        f["means"][:n] = p
        f["quats"][:n] = rng.normal(size=(n, 4))
        f["log_scales"][:n] = np.log(rng.uniform(0.01, 0.03, (n, 3)))
        f["sh_dc"][:n] = rng.normal(0, 0.5, (n, 1, 3))
        f["opacity_logit"][:n] = rng.normal(-1.5, 0.5, (n, 1))
        f["valid"][:n] = True
        c, s = np.cos(yaw), np.sin(yaw)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.diag(
            [0.3, 0.2, 0.25])
        m[:3, 3] = t
        d = {"delta_r": np.r_[1.0, 0, 0, 0] + rng.normal(0, 0.02, 4),
             "delta_s": 1.0 + rng.normal(0, 0.02, 3),
             "delta_t": rng.normal(0, 0.05, 3)}
        parts.append(BoxInstance(
            convert.field_from_numpy(f, device=device),
            torch.from_numpy(m).to(device),
            BoxDeltas(**{k: torch.tensor(v, dtype=torch.float32,
                                         device=device, requires_grad=True)
                         for k, v in d.items()})))
    return parts


def _static_field(device, n=3000, seed=2):
    from vegs_torch import convert

    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 10.0, n)
    return convert.field_from_numpy({
        "means": np.stack([rng.uniform(-0.45, 0.45, n) * z,
                           rng.uniform(-0.18, 0.18, n) * z, z], 1),
        "quats": rng.normal(size=(n, 4)),
        "log_scales": np.log(rng.uniform(0.02, 0.3, (n, 3))),
        "sh_dc": rng.normal(0, 0.5, (n, 1, 3)),
        "sh_rest": rng.normal(0, 0.1, (n, 15, 3)),
        "opacity_logit": rng.normal(0, 1.5, (n, 1)),
        "valid": np.ones(n, bool)}, device=device)


def test_render_all_with_boxes_kernels_match_plain(cuda):
    """`render_all` of a field and two boxes on the card launches K4 and
    K1 once each; K1 and K4 on that frame's concatenated inputs hold
    against their plain versions (the limits of the tests above); and the
    card's render equals the CPU's (plain versions) within 1e-4 on >=
    99.9% of the rgb values."""
    from vegs_torch.render import (_box_arrays, _concat_arrays, field_arrays,
                                   render_all)

    cfg = CFG._replace(k_cap=1 << 18, k_pad=1 << 18)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        field, boxes = _static_field(dev), _box_parts(dev)
        _, cam = _scene(dev, n=10)
        before = (blend_cuda.blend.launches, satcull.satcount_gathered.launches)
        with torch.no_grad():
            out, bounds = render_all(cam, field, boxes, config=cfg)
        launched = (blend_cuda.blend.launches - before[0],
                    satcull.satcount_gathered.launches - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        assert bounds == [0, 3000, 7096, 15288] and int(out.num_dropped) == 0
        outs[dev.type] = out
        if dev.type == "cuda":
            with torch.no_grad():
                a = _concat_arrays([field_arrays(field)]
                                   + [_box_arrays(b, 3) for b in boxes])
                st = stage(a.means, a.quats, a.scales, a.opacities, a.shs,
                           cam, valid=a.valid, config=cfg)
            assert st.sat_counts is not None
            k4 = satcull.satcount_gathered(st.pay_rows, st.rb.gidx_sorted,
                                           st.rb.raw_starts, st.grid)
            k4_ref = satcull.satcount_gathered_ref(
                st.pay_rows, st.rb.gidx_sorted, st.rb.raw_starts, st.grid)
            dk = (k4.long() - k4_ref.long()).abs()
            assert bool(((dk == 0) | (dk == 256)).all())
            g = st.grid
            args = (st.payload_f32, st.payload_aux, st.binned.tile_starts, g,
                    g.padded_height, g.padded_width)
            k1, stop = blend_cuda.blend(*args, return_stop=True)
            ref, stop_ref = blend_cuda.blend_ref_tiles(*args, return_stop=True)
            torch.cuda.synchronize()
            flips = stop != stop_ref
            bad = ((k1 - ref).abs() > 1e-5 + 1e-4 * ref.abs()).any(dim=0) & ~flips
            assert int(bad.sum()) == 0
            assert int(flips.sum()) <= 1e-3 * flips.numel()
    d = (outs["cuda"].rgb.cpu() - outs["cpu"].rgb).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.999


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_box_step_grads_kernels_match_plain(cuda, aux):
    """One training step's gradients with two boxes -- every static leaf,
    the means2d tap, every leaf of both box fields and of both residuals --
    through the kernels on the card against the plain versions on the CPU:
    relative L2 error <= 1e-4 per leaf."""
    from vegs_torch import convert
    from vegs_torch.boxmodel import BoxDeltas
    from vegs_torch.config import VegsConfig
    from vegs_torch.train import loss_fn

    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    normal = rng.normal(size=(3, H, W)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        field, boxes = _static_field(dev), _box_parts(dev)
        _, cam = _scene(dev, n=10)
        rows = field.capacity + sum(b.field.capacity for b in boxes)
        tap = torch.zeros((rows, 2), device=dev, requires_grad=True)
        loss, *_ = loss_fn(field, tap, cam, torch.from_numpy(gt).to(dev),
                           torch.from_numpy(normal).to(dev), 1.0, 3,
                           torch.zeros(3, device=dev),
                           opt_cfg=VegsConfig().opt,
                           raster_cfg=CFG._replace(
                               k_cap=1 << 18, k_pad=1 << 18,
                               forward_only=False, payload_dtype=aux),
                           boxes=boxes, lambda_reg=1e-3)
        loss.backward()
        g = {k: getattr(field, k).grad.cpu() for k in convert.FIELD_KEYS[:-1]}
        g["means2d"] = tap.grad.cpu()
        for i, b in enumerate(boxes):
            g.update({f"box{i} {k}": getattr(b.field, k).grad.cpu()
                      for k in ("means", "quats", "log_scales", "sh_dc",
                                "opacity_logit")})
            g.update({f"delta{i} {k}": getattr(b.deltas, k).grad.cpu()
                      for k in BoxDeltas.LEAVES})
        grads[dev.type] = g
    for k, ref in grads["cpu"].items():
        err = float((grads["cuda"][k] - ref).norm() / ref.norm())
        print(f"box step gradient {aux} {k}: {err}")
        assert ref.norm() > 0 and err <= GRAD_RTOL, (k, err)


def test_guided_step_launches_each_kernel_twice(cuda):
    """One diffusion-guided training step (SDS, the perceptual term on) on
    a reduced scene: the main render and the augmented view's render each
    launch K1-K4 once, and every metric is finite with nothing dropped."""
    from vegs_torch import gaussians, optim
    from vegs_torch.config import VegsConfig
    from vegs_torch.diffusion.pipeline import DiffusionModels
    from vegs_torch.gaussians import DensifyStats
    from vegs_torch.losses import vgg
    from vegs_torch.losses.sd_guidance import SDGuidance
    from vegs_torch.scene.cameras import augment_camera
    from vegs_torch.scene.dataset_readers import camera_from_info
    from vegs_torch.train import GuidedView, Perceptual, TrainState, train_step
    from vegs_torch.utils.synthetic import street_camera_infos

    rng = np.random.default_rng(5)
    n = 20_000
    z = rng.uniform(2.0, 40.0, n).astype(np.float32)
    xyz = np.stack([z * np.tan(0.6) * rng.uniform(-0.95, 0.95, n),
                    z * np.tan(0.2) * rng.uniform(-0.95, 0.95, n), z], 1)
    op = rng.uniform(0.2, 0.95, n)
    field = gaussians.from_ply_arrays(
        xyz.astype(np.float32), rng.uniform(-1, 1.5, (n, 3)).astype(np.float32),
        rng.normal(0, 0.1, (n, 45)).astype(np.float32),
        np.log(op / (1 - op)).astype(np.float32),
        np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32), device=cuda)
    cam = camera_from_info(street_camera_infos(1, 128, 512, fovx=1.2,
                                               fovy=0.4)[0])
    cfg = VegsConfig()
    cfg.sd.sd_image_size = 64
    aug = augment_camera(cam, cfg.sd, np.random.default_rng(6))[0]
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    guidance = SDGuidance(DiffusionModels.tiny(g, lora_rank=4),
                          guidance_mode="sds", start_iter=0, max_iters=100)
    counters = {"K1": blend_cuda.blend, "K2": blend_cuda.blend_bwd,
                "K3": segreduce.gather_expand_bwd,
                "K4": satcull.satcount_gathered}
    st = TrainState(field=field, opt=optim.adam_init(field),
                    stats=DensifyStats.zeros(field.capacity, cuda), step=10)
    gt = torch.rand((3, 128, 512), generator=g, device=cuda)
    for c in counters.values():
        c.launches = 0
    _, m, _ = train_step(
        st, cam.device_params(cuda), gt, torch.zeros_like(gt), 0.0, 3,
        torch.zeros(3, device=cuda), opt_cfg=cfg.opt,
        raster_cfg=RasterizeConfig(k_cap=1 << 20, k_pad=1 << 20,
                                   sat_cull=True),
        spatial_scale=1.0,
        guidance=GuidedView(guidance, aug.device_params(cuda), 10, g),
        perceptual=Perceptual(vgg.init_params(g).requires_grad_(False), 0.1))
    torch.cuda.synchronize()
    assert {k: c.launches for k, c in counters.items()} == dict.fromkeys(
        counters, 2)
    m = {k: float(v) for k, v in m.items()}
    assert all(np.isfinite(v) for v in m.values()), m
    assert m["num_dropped"] == m["aug_num_dropped"] == 0
    assert m["guidance_loss"] > 0 and m["perceptual_loss"] > 0


# -- the offline tools -----------------------------------------------------------

# the DPT crop, card against CPU: the largest |d| of the unit normals, scaled
# by the length of the decoded vector each normalizes where that is under 1
# (tests/test_torch_dpt.py); control: the card's readout projections with
# their cls-token columns zeroed
DPT_CROP_LIMIT = 1e-3
# one LoRA update (AdamW from zero moments), card against CPU, at lr: every
# LoRA element within 2 lr, and all but 2% within 1e-3 lr (Adam divides
# each component by its own root mean square, so one whose gradient is
# near zero moves by up to lr whatever its float32 summation order);
# control: the card's update with one micro-batch's timestep moved by 100
LORA_LR, LORA_SHARE = 1e-3, 0.02


def _dpt_reading(n_card, want, length):
    d = (n_card.cpu() - want).abs() * torch.clamp(length, max=1.0)
    return float(d.max())


def test_dpt_crop_card_matches_cpu(cuda):
    """The tiny DPT with the project readout: one crop on the card against
    the CPU, float32 on both."""
    from vegs_torch.priors.dpt import DPTConfig, dpt_from_state, init_dpt

    torch.backends.cudnn.allow_tf32 = False
    cfg = DPTConfig.tiny()
    cpu = init_dpt(torch.Generator().manual_seed(0), cfg).eval()
    card = dpt_from_state(cpu.state_dict(), cfg, cuda)
    heads = {}
    cpu.head_out.register_forward_hook(
        lambda m, i, o: heads.__setitem__("out", o))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.inference_mode():
        want = cpu(x)
        length = torch.linalg.vector_norm(
            (torch.clamp(heads["out"], 0, 1) - 0.5) * 2, dim=1, keepdim=True)
        sound = _dpt_reading(card(x.to(cuda)), want, length)
        for lin in (card.post3_readout, card.post4_readout):
            lin.weight[:, cfg.embed_dim:] = 0
        control = _dpt_reading(card(x.to(cuda)), want, length)
    print(f"DPT crop reading {sound:.3e} control {control:.3e}")
    assert sound <= DPT_CROP_LIMIT < control


def test_lora_update_card_matches_cpu(cuda):
    """One `train_lora` step (grad-accum 2) of the tiny stack on the card
    against the CPU, on the same draws, TF32 off."""
    import copy

    from vegs_torch.diffusion import lora
    from vegs_torch.diffusion.pipeline import DiffusionModels

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    cpu = DiffusionModels.tiny(g, lora_rank=4)
    with torch.no_grad():   # non-zero up-projections: the adapters act
        for n, p in cpu.unet.named_parameters():
            if n.endswith("lora_up.weight"):
                p.normal_(0.0, 0.05, generator=g)
    on_card = DiffusionModels(
        unet=copy.deepcopy(cpu.unet).to(cuda),
        vae=copy.deepcopy(cpu.vae).to(cuda),
        schedule=cpu.schedule._replace(
            betas=cpu.schedule.betas.to(cuda),
            alphas_cumprod=cpu.schedule.alphas_cumprod.to(cuda)),
        text_embeddings=cpu.text_embeddings.to(cuda))
    images = np.random.default_rng(2).uniform(0, 1, (2, 3, 40, 48)).astype(
        np.float32)
    draws = [lora.draw_micro_batch(g, images.shape, 32, 1, (1, 4, 16, 16),
                                   1000) for _ in range(2)]

    def leaves(m):
        return {n: p.detach().cpu().clone()
                for n, p in m.unet.named_parameters() if lora.is_lora_path(n)}

    def run(models, ds):
        before = leaves(models)
        _, losses = lora.train_lora(models, images, steps=1, grad_accum=2,
                                    lr=LORA_LR, crop=32, draws=ds)
        after = leaves(models)
        with torch.no_grad():
            for n, p in models.unet.named_parameters():
                if n in before:
                    p.copy_(before[n])
        return after, losses

    want, wl = run(cpu, draws)
    got, gl = run(on_card, draws)
    moved = [d._replace(t=d.t + 100) if i == 0 else d
             for i, d in enumerate(draws)]
    ctl, _ = run(on_card, moved)

    def reading(a):
        d = torch.cat([(a[n] - want[n]).abs().flatten() for n in want])
        return float((d > 1e-3 * LORA_LR).float().mean()), float(d.max())

    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    share, worst = reading(got)
    c_share, _ = reading(ctl)
    print(f"LoRA update: share off {share:.4f} (max {worst / LORA_LR:.2e} lr)"
          f", control {c_share:.4f}")
    assert worst <= 2 * LORA_LR
    assert share <= LORA_SHARE < c_share


# -- multi-device paths (vegs_torch.parallel) ----------------------------------
# the tile-sharded TP step's moments against one single-device step's: the
# same sums in another order (the exchange, the image gather's backward)
TP_MU_RTOL = 1e-4


def _check_parallel(results, transport):
    import numpy as np

    for r in results:
        assert r["transport"] == transport
        assert r["sat_cull"]  # the reference render is the main path's
        assert all(r["gauss"]) and all(r["tile"]), r
        assert r["tile_dropped"] == 0 and r["tp_dropped"] == 0
        assert r["denom_equal"]
        np.testing.assert_allclose(r["tp_loss"], r["loss"], rtol=1e-5)
        print(f"{transport}: TP moments against one device: "
              f"{r['tp_mu_gap']:.3e}")
        assert r["tp_mu_gap"] <= TP_MU_RTOL


def test_parallel_nccl_single_rank(cuda, tmp_path):
    """A world of one under NCCL: the sharded renders equal the
    single-device render to the bit, the TP step the single-device step."""
    import torch_parallel_workers as workers
    from vegs_torch.parallel import launch

    _check_parallel(launch.spawn(workers.gpu_sharded, 1, "nccl",
                                 backend="nccl",
                                 init_file=tmp_path / "rendezvous"), "nccl")


def test_parallel_gloo_host_pair(cuda, tmp_path):
    """Two gloo ranks sharing card 0 (every collective through the host):
    the sharded renders equal the single-device render to the bit, each
    rank's TP rows the single-device step's."""
    import torch_parallel_workers as workers
    from vegs_torch.parallel import launch

    _check_parallel(launch.spawn(workers.gpu_sharded, 2, "gloo",
                                 backend="gloo",
                                 init_file=tmp_path / "rendezvous"),
                    "gloo-host")
