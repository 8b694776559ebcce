"""The port's host-side helpers against vegs_tpu's: the native library
(`vegs_torch.native`), the numerical audits (`vegs_torch.utils.debug`),
the StyleGAN2 image ops (`vegs_torch.ops.image_ops`) and the operator's
trace (`vegs_torch.utils.trace.trace_steps`).

  * native: the port builds `native/vegs_native.cpp` with g++ into
    build/vegs_torch/<hash>/ (not the committed .so, which the JAX package
    loads); `knn_mean_sq_dist` within 5e-7 relative of JAX's on the same
    points (the same C++, but the committed .so was built with
    -march=native, whose FMA contractions round the squared distances
    otherwise: 2.3e-7 read here, on 15% of the points), `read_ply_columns`
    equal to the bit on a PLY written by each package; a failed build
    raises.
  * debug: tests/test_debug_utils.py ported (the first non-finite op
    raises and is named; nested audits), `nan_guard` equal to JAX's.
  * image_ops: `upfirdn2d` (up and down 1-2, with the blur pads) and
    `fused_leaky_relu` within 1e-6 of JAX's (float32 convolutions summed
    in another order), `make_fir_kernel` equal.
  * trace: `trace_steps` writes a TensorBoard trace.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vegs_torch import native as tnative
from vegs_torch.ops import image_ops as tops
from vegs_torch.utils import debug as tdebug, trace as ttrace
from vegs_tpu import native as jnative
from vegs_tpu.ops import image_ops as jops
from vegs_tpu.utils import debug as jdebug


# -- native ------------------------------------------------------------------


def test_knn_matches_jax():
    assert jnative.available()
    pts = np.random.default_rng(0).normal(size=(3000, 3)).astype(np.float32)
    pts[:50] *= 30.0
    for k in (3, 5):
        got = tnative.knn_mean_sq_dist(pts, k)
        assert got.dtype == np.float32 and got.shape == (3000,)
        np.testing.assert_allclose(got, jnative.knn_mean_sq_dist(pts, k),
                                   rtol=5e-7, atol=0)
    lib = tnative.library_path()
    assert lib.exists() and "build" in lib.parts
    assert lib.parent.parent.name == "vegs_torch"


def test_read_ply_columns_matches_jax(tmp_path):
    from vegs_torch.scene import dataset_readers as tread
    from vegs_tpu.scene import dataset_readers as jread

    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    names = ("x", "y", "z", "red", "nz")
    for i, mod in enumerate((tread, jread)):
        path = tmp_path / f"p{i}.ply"
        mod.storePly(path, xyz, rgb)
        got = tnative.read_ply_columns(path, names)
        np.testing.assert_array_equal(got, jnative.read_ply_columns(path,
                                                                    names))
        np.testing.assert_array_equal(got[:3].T, xyz)
        np.testing.assert_array_equal(got[3], rgb[:, 0])
    with pytest.raises(ValueError):
        tnative.read_ply_columns(tmp_path / "p0.ply", ("nope",))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build()


# -- debug -------------------------------------------------------------------


def test_checked_raises_on_nan_and_names_the_op():
    def bad(x):
        return torch.log(x) * 2.0       # NaN for negative input

    f = tdebug.checked(bad)
    assert np.isfinite(float(f(torch.tensor(2.0))))
    with pytest.raises(FloatingPointError, match="log"):
        f(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError, match="div"):
        tdebug.checked(lambda x: x / 0.0)(torch.ones(3))
    # integer outputs are not audited
    assert int(tdebug.checked(lambda x: x // 2)(torch.tensor(5))) == 2


def test_assert_all_finite():
    good = {"a": torch.ones(3), "b": {"c": np.zeros(2)}, "d": [torch.ones(1)]}
    tdebug.assert_all_finite(good)
    bad = {"a": torch.tensor([1.0, float("nan")]),
           "b": {"c": [torch.ones(2), torch.tensor([float("inf")])]},
           "i": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError) as e:
        tdebug.assert_all_finite(bad, "state")
    msg = str(e.value)
    assert "state" in msg and "['a']: 1/2" in msg and "['b']['c'][1]: 1/1" in msg


def test_nan_guard_matches_jax():
    x = np.array([1.0, np.nan, np.inf, -np.inf, -2.5], np.float32)
    t = {"x": torch.from_numpy(x), "i": torch.tensor([1, 2]),
         "n": [torch.from_numpy(x[::-1].copy())]}
    j = {"x": jnp.asarray(x), "i": jnp.asarray([1, 2]),
         "n": [jnp.asarray(x[::-1].copy())]}
    got, want = tdebug.nan_guard(t), jdebug.nan_guard(j)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["n"][0].numpy(),
                                  np.asarray(want["n"][0]))
    np.testing.assert_array_equal(got["i"].numpy(), [1, 2])
    assert got["x"][1] == 0.0


# -- image ops -----------------------------------------------------------------


@pytest.mark.parametrize("up, down, pad, taps", [
    (1, 1, (0, 0), [1.0]), (1, 1, (1, 2), [1, 3, 3, 1]),
    (2, 1, (2, 1), [1, 3, 3, 1]), (1, 2, (1, 1), [1, 3, 3, 1]),
    (2, 2, (1, 2), [1, 2, 1]), (1, 1, (-1, 2), [1, 3, 3, 1])])
def test_upfirdn2d_matches_jax(up, down, pad, taps):
    x = np.random.default_rng(2).normal(size=(2, 9, 11, 3)).astype(np.float32)
    k = tops.make_fir_kernel(taps) * (up * up)
    np.testing.assert_array_equal(k.numpy() / (up * up),
                                  np.asarray(jops.make_fir_kernel(taps)))
    want = jops.upfirdn2d(jnp.asarray(x), jnp.asarray(k.numpy()), up=up,
                          down=down, pad=pad)
    got = tops.upfirdn2d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), k,
                         up=up, down=down, pad=pad)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-6, rtol=1e-6)


def test_fused_leaky_relu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    want = jops.fused_leaky_relu(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 jnp.asarray(b))
    got = tops.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-6, rtol=1e-6)
    z = tops.fused_leaky_relu(torch.tensor([-1.0, 2.0]), torch.zeros(2))
    np.testing.assert_allclose(z.numpy(), [-0.2 * np.sqrt(2), 2 * np.sqrt(2)],
                               rtol=1e-6)


# -- trace ---------------------------------------------------------------------


def test_trace_steps_writes_a_trace(tmp_path):
    with ttrace.trace_steps(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files
