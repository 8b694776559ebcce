"""The plain reference against values worked out by hand at toy size."""

import math

import numpy as np
import pytest
import torch

from bench_h100.reference import cameras as rc, raster, train as rt

H, W = 32, 64


def one_view():
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
    return rc.view(np.eye(4), k, H, W)


def leaves(means, opac, dc, scale=0.05, rest=0.0):
    n = len(means)
    t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    return {"means": t(means), "quats": t([[1.0, 0, 0, 0]] * n),
            "log_scales": t([[math.log(scale)] * 3] * n),
            "sh_dc": t([[d] for d in dc]),
            "sh_rest": torch.full((n, 15, 3), rest, dtype=torch.float64),
            "opacity_logit": t([[math.log(o / (1 - o))] for o in opac])}


def test_pixel_centre_and_colour():
    v = one_view()
    p = leaves([[0.0, 0.0, 5.0]], [0.5], [[0.0, 0.0, 0.0]])
    pr = raster.project(p, v)
    # ndc 0 -> ((0 + 1) * size - 1) / 2
    assert pr.m2d[0].tolist() == pytest.approx([(W - 1) / 2, (H - 1) / 2])
    assert pr.rgb[0].tolist() == pytest.approx([0.5, 0.5, 0.5])
    assert pr.depth[0].item() == pytest.approx(5.0)
    # isotropic: cov = (50 * 0.05 / 5)^2 + 0.3 on the diagonal
    c = (50 * 0.05 / 5) ** 2 + 0.3
    assert pr.conic[0].tolist() == pytest.approx([1 / c, 0.0, 1 / c])


def test_blend_two_gaussians_and_stop():
    v = one_view()
    dc = [[0.5 / raster.C0] * 3, [-0.5 / raster.C0, 0.0, 0.0]]
    p = leaves([[0.0, 0.0, 4.0], [0.0, 0.0, 6.0]], [0.6, 0.8], dc)
    img, pr = raster.render(p, v, 0, aux_dtype="f32")
    # the pixel nearest the means: offsets 0.5 px in both axes
    x, y = W // 2, H // 2
    a = []
    for i in range(2):
        dx = x - pr.m2d[i, 0].item()
        dy = y - pr.m2d[i, 1].item()
        ca, cb, cc = pr.conic[i].tolist()
        a.append(min(0.99, pr.opacity[i].item()
                     * math.exp(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy)))
    c0, c1 = [1.0, 1.0, 1.0], [0.0, 0.5, 0.5]
    want = [a[0] * c0[j] + (1 - a[0]) * a[1] * c1[j] for j in range(3)]
    assert img.rgb[:, y, x].tolist() == pytest.approx(want, rel=1e-12)
    assert img.alpha[0, y, x].item() == pytest.approx(1 - (1 - a[0]) * (1 - a[1]))
    # opaque layers: the pixel stops before T would fall under 1e-4
    p = leaves([[0.0, 0.0, 3.0 + 0.1 * i] for i in range(8)], [0.95] * 8,
               [[0.0, 0.0, 0.0]] * 8, scale=0.5)
    img, pr = raster.render(p, v, 0, aux_dtype="f32")
    t = 1.0
    for i in range(8):
        dx = x - pr.m2d[i, 0].item()
        dy = y - pr.m2d[i, 1].item()
        ca, cb, cc = pr.conic[i].tolist()
        ai = min(0.99, 0.95 * math.exp(-0.5 * (ca * dx * dx + cc * dy * dy)
                                        - cb * dx * dy))
        if t * (1 - ai) < 1e-4:
            break
        t = t * (1 - ai)
    assert i < 7
    assert 1 - img.alpha[0, y, x].item() == pytest.approx(t, rel=1e-12)


def test_culled_and_bf16_aux():
    v = one_view()
    p = leaves([[0.0, 0.0, 0.1], [0.0, 0.0, 5.0]], [0.9, 0.9],
               [[0.1, 0.2, 0.3]] * 2)
    pr = raster.project(p, v)
    assert pr.visible.tolist() == [False, True]   # in front of z 0.2 only
    full, _ = raster.render(p, v, 0, aux_dtype="f32")
    half, _ = raster.render(p, v, 0, aux_dtype="bf16")
    gap = (full.rgb - half.rgb).abs().max().item()
    assert 0 < gap < 2 ** -8


def test_ssim_adam_and_lr():
    img = torch.rand(3, 20, 30, dtype=torch.float64)
    assert rt.ssim(img, img).item() == pytest.approx(1.0)
    assert rt.ssim(img, 1 - img).item() < 0.5
    assert rt.position_lr(0, 2.0) == pytest.approx(3.2e-5)
    assert rt.position_lr(30_000, 2.0) == pytest.approx(3.2e-6)
    # one Adam step moves each leaf by its rate against its gradient's sign
    v = one_view()
    st = rt.State(leaves([[0.0, 0.0, 5.0]], [0.5], [[0.2, 0.1, 0.0]]))
    gt = torch.zeros(3, H, W, dtype=torch.float64)
    n = torch.zeros(3, H, W, dtype=torch.float64)
    n[2] = -1
    before = st.field.p["sh_dc"].clone()
    loss, grads, _ = rt.step(st, v, gt, n, 1.0, "f32")
    moved = (st.field.p["sh_dc"] - before) / -torch.sign(grads["sh_dc"])
    assert moved.flatten().tolist() == pytest.approx([2.5e-3] * 3, rel=1e-9)
    assert loss > 0 and st.denom.tolist() == [1.0]


def test_interpolation_and_augmentation():
    a = rc.c2w_of(np.eye(3), np.zeros(3))
    yaw = 0.2
    r = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    b = rc.c2w_of(r, np.array([0.0, 0.0, 2.0]))
    traj = rc.interpolate([a, b], 4)
    assert len(traj) == 5
    mid = traj[2]
    assert mid[:3, 3].tolist() == pytest.approx([0.0, 0.0, 1.0])
    half = np.arccos((np.trace(mid[:3, :3]) - 1) / 2)
    assert half == pytest.approx(yaw / 2)
    up = rc.augment(a, add_tz=0.5)
    assert up[2, 3] == 0.5
    z = rc.augment(a, add_zrot_val=90.0)
    assert z[:3, 0].tolist() == pytest.approx([0.0, 1.0, 0.0], abs=1e-12)
