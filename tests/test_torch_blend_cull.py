"""The per-warp cull of kernels K1 and K2 against the compositing spec.

K1 and K2 (`vegs_torch/csrc/blend_fwd.cu`, `blend_bwd.cu`) skip, per warp,
every instance whose footprint box (`csrc/splat.cuh: footprint_box`) misses
the warp's 8x4 rectangle of pixels. That is lossless only if the box holds
every pixel where the spec's float32 splat math accepts the instance
(alpha > 0). The kernels cannot run here, so these tests hold the box's
plain twin (`blend_cuda.footprint_box`, the same formula and inflation) and
the warp rectangles (`thread_pixels`, `warp_rects`, `box_hits`) against
`blend_ref.splat_terms` on seeded draws: typical splats, opacities just
above and below 1/255, near-singular and non-positive-definite conics,
means far outside the tile, non-finite inputs, and 16x16 and 16x32 tiles.
There is no tolerance: not one accepted pixel may fall outside its box.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from vegs_torch.ops import blend_cuda
from vegs_torch.ops.blend_ref import ALPHA_MIN, splat_terms

F32 = np.float32
AMIN = float(np.float32(ALPHA_MIN))  # the kernels' 1.0f / 255.0f


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _conics(rng, n, sig_lo, sig_hi):
    """Conics (a, b, c) of random rotated 2D covariances with standard
    deviations in [sig_lo, sig_hi] pixels (log-uniform)."""
    s1, s2 = np.exp(rng.uniform(np.log(sig_lo), np.log(sig_hi), (2, n)))
    th = rng.uniform(0, np.pi, n)
    co, si = np.cos(th), np.sin(th)
    # cov = R diag(s1^2, s2^2) R^T, conic = cov^-1
    i1, i2 = 1 / s1**2, 1 / s2**2
    a = co * co * i1 + si * si * i2
    c = si * si * i1 + co * co * i2
    b = co * si * (i1 - i2)
    return a, b, c


def _case(name, rng, n=192):
    """(mx, my, a, b, c, op) float32 arrays of one family of instances."""
    mx = rng.uniform(-40, 1500, n)
    my = rng.uniform(-40, 400, n)
    op = rng.uniform(0.003, 1.0, n)
    if name == "typical":
        a, b, c = _conics(rng, n, 0.3, 12.0)
    elif name == "op_near_min":
        a, b, c = _conics(rng, n, 1.0, 10.0)
        ulps = rng.integers(-8, 9, n)
        op = np.full(n, AMIN, F32)
        for i, u in enumerate(ulps):  # a few ulps above and below 1/255
            for _ in range(abs(int(u))):
                op[i] = np.nextafter(op[i], F32(np.sign(u) * np.inf))
        op[: n // 4] = AMIN * rng.uniform(0.999, 1.001, n // 4)
        op[n // 2:] = AMIN * rng.uniform(1.0, 1.5, n - n // 2)
        mx[::2], my[::2] = np.round(mx[::2]), np.round(my[::2])  # dx = 0
    elif name == "near_singular":
        a, b, c = _conics(rng, n, 0.002, 40.0)
        k = n // 2  # and b^2 within a relative 1e-9..1e-2 of a c
        a[:k] = np.exp(rng.uniform(np.log(1e-3), np.log(10.0), k))
        c[:k] = np.exp(rng.uniform(np.log(1e-3), np.log(10.0), k))
        gap = 10.0 ** rng.uniform(-9, -2, k)
        b[:k] = np.sqrt(a[:k] * c[:k] * (1 - gap)) * rng.choice([-1, 1], k)
    elif name == "non_pd":
        a, b, c = _conics(rng, n, 0.5, 8.0)
        k = n // 3
        b[:k] = np.sqrt(a[:k] * c[:k]) * rng.uniform(1.0, 3.0, k)
        a[k:2 * k] = -a[k:2 * k]
        c[2 * k:] = rng.uniform(-0.5, 0.0, n - 2 * k)
    elif name == "far_means":
        a, b, c = _conics(rng, n, 500.0, 5000.0)
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 10.0 ** rng.uniform(3, 5, n)
        mx, my = 700 + r * np.cos(ang), 180 + r * np.sin(ang)
    else:
        raise ValueError(name)
    return [np.asarray(x, F32) for x in (mx, my, a, b, c, op)]


def _accepted(px, py, inst):
    """[N, P] bool: where the spec's float32 math accepts instance n at
    pixel p (alpha > 0), and the float32 differences dx, dy [N, P]."""
    mx, my, a, b, c, op = (torch.from_numpy(x)[:, None] for x in inst)
    px = torch.as_tensor(px, dtype=torch.float32)
    py = torch.as_tensor(py, dtype=torch.float32)
    alpha, valid, _, _ = splat_terms(px, py, mx, my, a, b, c, op)
    return valid & (alpha > 0), px - mx, py - my


def _around_means(inst, half=48):
    """Per instance, the integer pixels of a (2 half + 1)^2 square around
    its mean: px, py [N, P]."""
    o = torch.arange(-half, half + 1, dtype=torch.float32)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    cx = torch.from_numpy(np.round(inst[0]).astype(F32))[:, None]
    cy = torch.from_numpy(np.round(inst[1]).astype(F32))[:, None]
    return cx + ox.reshape(1, -1), cy + oy.reshape(1, -1)


def _assert_boxes_hold(inst, px, py):
    acc, dx, dy = _accepted(px, py, inst)
    rx, ry = blend_cuda.footprint_box(*(torch.from_numpy(x) for x in inst))
    out = acc & ((dx.abs() > rx[:, None]) | (dy.abs() > ry[:, None]))
    assert not out.any(), (
        f"{int(out.sum())} accepted pixels outside their box, instances "
        f"{torch.nonzero(out.any(dim=1)).flatten()[:10].tolist()}")
    return acc, rx, ry


@pytest.mark.parametrize("name", ["typical", "op_near_min", "near_singular",
                                  "non_pd", "far_means"])
def test_box_holds_every_accepted_pixel(name):
    rng = np.random.default_rng(["typical", "op_near_min", "near_singular",
                                 "non_pd", "far_means"].index(name) + 11)
    inst = _case(name, rng)
    if name == "far_means":  # the pixels of one 16x32 tile's neighbourhood
        ys, xs = torch.meshgrid(torch.arange(150.0, 214.0),
                                torch.arange(660.0, 740.0), indexing="ij")
        px, py = xs.reshape(1, -1), ys.reshape(1, -1)
    else:
        px, py = _around_means(inst)
    acc, rx, ry = _assert_boxes_hold(inst, px, py)
    assert int(acc.sum()) > (100 if name == "op_near_min" else 1000)
    if name == "typical":
        # the box is close to the exact ellipse's (the shrink of the
        # diagonal widens it most for elongated splats), so the test above
        # is not passed by an open box
        mx, my, a, b, c, op = (x.astype(np.float64) for x in inst)
        det = a * c - b * b
        tau = np.maximum(np.log(255 * op), 0)
        for r, num in ((rx, c), (ry, a)):
            ratio = r.numpy() / np.sqrt(2 * tau * num / det)
            assert np.all(ratio <= 1.05) and np.median(ratio) <= 1.001
        # and the accepted pixels reach close to its edge (integer pixels
        # sample the ellipse, so within a pixel or two)
        reach = torch.where(acc, (px - torch.from_numpy(inst[0])[:, None]).abs(),
                            torch.zeros(())).amax(dim=1)
        big = rx > 6
        assert bool((reach[big] >= rx[big] - 2.0).all())
        assert float((reach[big] / rx[big]).median()) > 0.9
    if name == "non_pd":
        assert bool(torch.isinf(rx).all() & (rx > 0).all())
    if name == "op_near_min":
        below = torch.from_numpy(inst[5]) < blend_cuda.ALPHA_MIN_F32
        assert 0 < int(below.sum()) < below.numel()
        assert bool((rx[below] == -math.inf).all())
        assert bool(torch.isfinite(rx[~below]).all())


def test_box_edge_cases():
    inf = math.inf
    nan = math.nan
    amin = float(blend_cuda.ALPHA_MIN_F32)
    below = float(np.nextafter(F32(amin), F32(0)))
    rows = [  # mx, my, a, b, c, op -> expected kind of box
        ((5, 5, 0.1, 0.0, 0.2, below), "empty"),
        ((5, 5, 0.1, 0.0, 0.2, amin), "finite"),
        ((5, 5, 0.1, 0.0, 0.2, 0.0), "empty"),
        ((5, 5, 1.0, 1.0, 1.0, 0.5), "open"),       # det = 0
        ((5, 5, 1.0, 2.0, 1.0, 0.5), "open"),       # det < 0
        ((5, 5, -1.0, 0.0, 1.0, 0.5), "open"),      # a <= 0
        ((5, 5, 1.0, 0.0, 0.0, 0.5), "open"),       # c = 0
        ((nan, 5, 1.0, 0.0, 1.0, 0.5), "open"),
        ((5, 5, 1.0, nan, 1.0, 0.5), "open"),
        ((5, 5, 1.0, 0.0, 1.0, nan), "open"),
        ((inf, 5, 1.0, 0.0, 1.0, 0.5), "open"),
        ((5, 5, inf, 0.0, 1.0, 0.5), "open"),
    ]
    cols = [torch.tensor([r[0][i] for r in rows], dtype=torch.float32)
            for i in range(6)]
    rx, ry = blend_cuda.footprint_box(*cols)
    for (vals, kind), x, y in zip(rows, rx.tolist(), ry.tolist()):
        want = {"empty": -inf, "open": inf}.get(kind)
        if want is None:
            assert 0 < x < 100 and 0 < y < 100, (vals, x, y)
        else:
            assert x == want and y == want, (vals, kind, x, y)
    # a NaN mean is never rejected by the rectangle test, an empty box
    # always is
    hits = blend_cuda.box_hits(0, 7, 0, 3, cols[0], cols[1], rx, ry)
    assert bool(hits[7]) and not bool(hits[0]) and not bool(hits[2])


@pytest.mark.parametrize("tile", [(16, 16), (16, 32), (32, 32), (8, 12)])
def test_thread_pixel_map(tile):
    """Each tile shape the wrappers take gets a bijective thread -> pixel
    map; with sides divisible by 8 and 4, each warp's 32 pixels fill an 8x4
    rectangle exactly."""
    th, tw = tile
    lx, ly = blend_cuda.thread_pixels(th, tw)
    assert len(set(zip(lx.tolist(), ly.tolist()))) == th * tw
    assert int(lx.max()) == tw - 1 and int(ly.max()) == th - 1
    rects = blend_cuda.warp_rects(th, tw)
    assert rects.shape == (th * tw // 32, 4)
    w = torch.arange(th * tw) // 32
    r = rects[w]
    assert bool(((lx >= r[:, 0]) & (lx <= r[:, 1]) & (ly >= r[:, 2])
                 & (ly <= r[:, 3])).all())
    if tw % 8 == 0 and th % 4 == 0:
        assert bool(((rects[:, 1] - rects[:, 0] == 7)
                     & (rects[:, 3] - rects[:, 2] == 3)).all())


@pytest.mark.parametrize("tile", [(16, 16), (16, 32)])
def test_warp_cull_is_lossless(tile):
    """On one tile, every (warp, instance) pair where some pixel of the
    warp accepts the instance passes the rectangle test, for instances of
    every family around the tile; and the test does skip most pairs of the
    typical ones."""
    th, tw = tile
    ox, oy = 640.0, 160.0
    rng = np.random.default_rng(th * 100 + tw)
    lx, ly = blend_cuda.thread_pixels(th, tw)
    px = (lx.float() + ox)[None, :]
    py = (ly.float() + oy)[None, :]
    rects = blend_cuda.warp_rects(th, tw).float() + torch.tensor(
        [ox, ox, oy, oy])
    skipped = {}
    for name in ("typical", "op_near_min", "near_singular", "non_pd",
                 "far_means"):
        inst = _case(name, rng, n=512)
        if name != "far_means":  # means around the tile
            inst[0] = (ox - 24 + rng.uniform(0, tw + 48, 512)).astype(F32)
            inst[1] = (oy - 24 + rng.uniform(0, th + 48, 512)).astype(F32)
        acc, _, _ = _accepted(px, py, inst)                 # [N, P]
        warp_any = acc.reshape(acc.shape[0], -1, 32).any(dim=2).T  # [W, N]
        rx, ry = blend_cuda.footprint_box(*(torch.from_numpy(x) for x in inst))
        hits = blend_cuda.box_hits(
            rects[:, 0:1], rects[:, 1:2], rects[:, 2:3], rects[:, 3:4],
            torch.from_numpy(inst[0])[None], torch.from_numpy(inst[1])[None],
            rx[None], ry[None])                             # [W, N]
        missed = warp_any & ~hits
        assert not missed.any(), (name, int(missed.sum()))
        skipped[name] = float((~hits).float().mean())
        if name == "typical":
            assert int(warp_any.sum()) > 100
    assert skipped["typical"] > 0.3, skipped


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(mx=st.floats(-2000, 2000, width=32), my=st.floats(-2000, 2000, width=32),
       s1=st.floats(0.01, 60.0), s2=st.floats(0.01, 60.0),
       th=st.floats(0.0, 3.15), op=st.floats(0.0, 1.0, width=32))
def test_box_holds_hypothesis(mx, my, s1, s2, th, op):
    """Drawn instances: every accepted pixel of a square around the mean
    reaching past the box lies inside it."""
    co, si = math.cos(th), math.sin(th)
    i1, i2 = 1 / s1**2, 1 / s2**2
    inst = [np.array([v], F32) for v in (
        mx, my, co * co * i1 + si * si * i2, co * si * (i1 - i2),
        si * si * i1 + co * co * i2, op)]
    rx, _ = blend_cuda.footprint_box(*(torch.from_numpy(x) for x in inst))
    r = float(rx[0])
    half = 8 if not math.isfinite(r) else min(int(r) + 3, 80)
    px, py = _around_means(inst, half)
    _assert_boxes_hold(inst, px, py)


def test_check_variants_need_a_card():
    """The cull-on/off launchers exist for the card's bit-identity check
    only: on CPU tensors they raise (there is no plain version of a cull
    that changes nothing)."""
    pf = torch.zeros((8, 256))
    pa = torch.zeros((16, 256))
    ts = torch.zeros(2, dtype=torch.int32)
    grid = blend_cuda.TileGrid(16, 16, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        blend_cuda.blend_check(pf, pa, ts, grid, 16, 16, cull=False)
    with pytest.raises(ValueError, match="CUDA"):
        blend_cuda.blend_bwd_check(pf, pa, ts, torch.zeros((12, 16, 16)),
                                   torch.zeros((12, 16, 16)), grid, cull=True)
