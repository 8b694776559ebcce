"""The port's sharded-path check (`vegs_torch.perf.shard_check`, the port of
perf/r07_shard_pallas.py) on the CPU at 64x256 with 3,000 Gaussians.

  * The scene: `refscale.build_scene` with the caller's generator equals,
    to the bit, what r07_shard_pallas.py:58-69 draws with the JAX
    package's tests/utils.py at that size, and the colours the TP step
    draws next are the script's (:146).
  * The unsharded side: the port's `rasterize` against the JAX package's
    `rasterize` (dense backend, jitted) on those inputs, f32 and bf16
    payloads: rgb, depth and alpha within 2e-5 absolute, depth also 1e-4
    relative (it sums depths of 2-60 m; float32 sums in other orders, the
    same bf16 rounding of the payload on both sides),
    k_cap 2^13 there (JAX's dense spec is O(k_cap x pixels); the scene
    drops nothing at it), the padded layouts at k_pad 2^14 (JAX) and 2^15
    (the port, whose tiles pad to 256 slots).
  * The D = 1 tile-sharded render: the JAX package's
    `make_tile_sharded_rasterize` at D = 1 raises a NameError
    (vegs_tpu/parallel/tile_sharded.py:221 reads `me`, which its ndev == 1
    branch never defines; ROADMAP Queue 3), so the port's is held against
    its own `rasterize`: `shard_check.run` on a gloo group of one rank,
    equal to the bit with both payloads, nothing dropped, the forward and
    backward of both paths and the TP step's losses finite (the TP step on
    1,000 means, capacity 2,048, k_cap 2^14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils import make_camera, random_gaussians
from vegs_torch.ops.rasterize import RasterizeConfig, rasterize
from vegs_torch.perf import refscale, shard_check

H, W, N, K_CAP = 64, 256, 3000, 1 << 14
JAX_K_CAP = 1 << 13  # JAX's dense spec is O(k_cap x pixels); nothing drops
JAX_K_PAD = 1 << 14  # the padded layouts at that k_cap: JAX's, the port's
K_PAD = 1 << 15
ATOL = 2e-5
DEPTH_RTOL = 1e-4    # depth sums alpha-weighted depths of 2-60 m


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_scene(n=N):
    """r07_shard_pallas.py:58-69 at (H, W, n), and its generator."""
    cam = make_camera(height=H, width=W, fovx=1.2, fovy=0.4)
    rng = np.random.default_rng(0)
    means, quats, scales, opac, shs = random_gaussians(
        rng, n, depth_range=(2.0, 60.0), xy_extent=40.0,
        scale_range=(0.002, 0.025))
    z = np.asarray(rng.uniform(2.0, 60.0, n), np.float32)
    u = rng.uniform(-0.95, 0.95, n)
    v = rng.uniform(-0.95, 0.95, n)
    means = np.stack([z * np.tan(0.6) * u, z * np.tan(0.2) * v, z], axis=1,
                     dtype=np.float32)
    return cam, [means, quats, scales, opac, shs], rng


@pytest.fixture(scope="module")
def scenes():
    jcam, jarr, jrng = jax_scene()
    trng = np.random.default_rng(refscale.SEED)
    tcam, tarr = refscale.build_scene(N, H, W, "cpu", rng=trng)
    return (jcam, jarr, jrng), (tcam, tarr, trng)


def test_scene_and_colour_draws_are_the_scripts(scenes):
    (_, jarr, jrng), (_, tarr, trng) = scenes
    for j, t in zip(jarr, tarr):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j, np.float32))
    np.testing.assert_array_equal(trng.uniform(0, 1, (10, 3)),
                                  jrng.uniform(0, 1, (10, 3)))


@pytest.mark.parametrize("pdt", ["f32", "bf16"])
def test_unsharded_side_matches_jax_rasterize(scenes, pdt):
    from vegs_tpu.ops.rasterize import RasterizeConfig as JConfig
    from vegs_tpu.ops.rasterize import rasterize as jrasterize

    (jcam, jarr, _), (tcam, tarr, _) = scenes
    cfg = JConfig(backend="dense", k_cap=JAX_K_CAP, k_pad=JAX_K_PAD,
                  payload_dtype=pdt)
    jo = jax.jit(lambda *a: jrasterize(*a, jcam, bg=jnp.zeros(3),
                                       config=cfg))(*map(jnp.asarray, jarr))
    with torch.no_grad():
        to = rasterize(*tarr, tcam, bg=torch.zeros(3),
                       config=RasterizeConfig(k_cap=JAX_K_CAP, k_pad=K_PAD,
                                              payload_dtype=pdt))
    assert int(jo.num_dropped) == int(to.num_dropped) == 0
    for k in ("rgb", "depth", "alpha"):
        np.testing.assert_allclose(getattr(to, k).numpy(),
                                   np.asarray(getattr(jo, k)),
                                   rtol=DEPTH_RTOL if k == "depth" else 0,
                                   atol=ATOL, err_msg=k)


def test_jax_tile_sharded_raises_at_one_device(scenes):
    from vegs_tpu.ops.rasterize import RasterizeConfig as JConfig
    from vegs_tpu.parallel.tile_sharded import (make_tile_mesh,
                                                make_tile_sharded_rasterize)

    (jcam, jarr, _), _ = scenes
    fn = make_tile_sharded_rasterize(make_tile_mesh(1), jcam,
                                     JConfig(backend="dense", k_cap=K_CAP))
    with pytest.raises(NameError):
        fn(*map(jnp.asarray, jarr), jnp.ones((N,), bool), jnp.zeros(3))


def test_d1_tile_sharded_equals_rasterize_to_the_bit():
    lines = []
    res = shard_check.run(device="cpu", n=N, h=H, w=W, k_cap=K_CAP, iters=1,
                          warmup=0, tp={"n": 1000, "capacity": 2048,
                                        "k_cap": K_CAP},
                          emit=lambda **kw: lines.append(kw))
    for pdt in ("f32", "bf16"):
        r = res["renders"][pdt]
        assert all(r["equal"].values()) and r["max_abs"] == 0.0
        assert r["psnr_db"] == 120.0
    fb = res["fwd_bwd"]
    assert fb["unsharded"]["loss"] == fb["tile_sharded"]["loss"]
    assert all("mpixs" not in x for x in fb.values())   # no host-clock rate
    assert res["tp"]["num_dropped"] == 0 and len(res["tp"]["losses"]) == 3
    assert [ln["step"] for ln in lines] == ["renders", "fwd_bwd", "tp"]
    assert not torch.distributed.is_initialized()
