"""The port's layout probes (vegs_torch/perf/micro3.py) against
perf/micro3_r02.py, loaded by path with an interpret-mode `pallas_call`:
the plain version of M1 (block sum) against `psum_consume` within 1e-6 of
the sum of |x|, the plain version of M2 (transpose) against
`pallas_transpose` bit for bit, the probes' inputs drawn as the JAX module
draws them, and each probe's step against the JAX step on the same numpy
arrays (integer probes exactly, float probes within 1e-5 of the sum of
|.|). The wrappers refuse shapes the JAX functions do not cover whole."""

import functools
import importlib.util
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from vegs_torch.perf import micro3

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
M1_RTOL, PROBE_RTOL = 1e-6, 1e-5
K_SMALL, N_SMALL = 1 << 17, 4096  # probes that take their arrays as args


def load_micro3(cache_dir):
    """perf/micro3_r02.py as a module whose Pallas kernels run in interpret
    mode. Its import sets a compilation-cache variable and extends
    sys.path: both are restored."""
    env, path = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    spec = importlib.util.spec_from_file_location(
        "micro3_r02", ROOT / "perf" / "micro3_r02.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


@pytest.fixture(scope="module")
def jm3(tmp_path_factory):
    """The JAX module, and each probe's (step, args) made in `ALL`'s order
    right after its import, as its __main__ makes them (the scatter probes
    draw their inputs then)."""
    mod = load_micro3(tmp_path_factory.mktemp("jax_cache"))
    return mod, {name: make() for name, make in mod.ALL.items()}


def _pair(x, bf16=False):
    """The same values as a jax array and a torch tensor (bf16 rounds to
    nearest even on both sides)."""
    j, t = jnp.asarray(x), torch.from_numpy(x)
    return (j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16 else (j, t)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32
                      ).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.itemsize == 2 else np.int32)


def _data(**kw):
    return micro3.Data(**{**dict.fromkeys(micro3.Data._fields), **kw})


@pytest.mark.parametrize("dtype,shape", [
    ("f32", (1 << 18, 8)), ("f32", (8, 1 << 18)),
    ("bf16", (1 << 17, 16)), ("bf16", (16, 1 << 17))])
def test_psum_plain_matches_pallas(jm3, dtype, shape):
    mod, _ = jm3
    x = np.random.default_rng(3).standard_normal(shape, dtype=np.float32)
    jx, tx = _pair(x, dtype == "bf16")
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    ref = float(mod.psum_consume(jx))
    got = micro3.psum_consume(tx)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == ()
    mag = float(np.abs(tx.double().numpy()).sum())
    assert abs(float(got) - ref) <= M1_RTOL * mag
    assert micro3.psum_parts_ref(tx).shape == (max(shape) // (1 << 17),)


@pytest.mark.parametrize("dtype,c", [("f32", 8), ("bf16", 16)])
def test_transpose_plain_matches_pallas_bit_exact(jm3, dtype, c):
    mod, _ = jm3
    x = np.random.default_rng(4).standard_normal((1 << 15, c),
                                                 dtype=np.float32)
    jx, tx = _pair(x, dtype == "bf16")
    ref = mod.pallas_transpose(jx)
    got = micro3.transpose(tx)
    assert got.shape == (c, 1 << 15) and got.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_make_data_draws_the_jax_inputs(jm3):
    mod, probes = jm3
    d = micro3.make_data("cpu")
    assert (d.k, d.n) == (mod.K, mod.N)
    for name, t, j in (("A8", d.a8, mod.A8), ("A16", d.a16, mod.A16),
                       ("TBL8", d.tbl8, mod.TBL8), ("TBL16", d.tbl16, mod.TBL16),
                       ("CUM", d.cum, mod.CUM), ("GIDX", d.gidx, mod.GIDX)):
        if t.is_floating_point():
            np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
    for name, pos, vals in (
            ("scatter_scalar_unique_sorted_500k_2M", d.pos_f, d.vals_f),
            ("scatter_int_unique_sorted_500k_2M", d.pos_i, d.vals_i)):
        jpos, jvals = probes[name][1]
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def _probe_inputs(mod, name):
    """(port Data, JAX args, sum of |.| of what the value sums or None for
    an integer probe) on the same numpy arrays."""
    rng = np.random.default_rng(5)
    if name.startswith("gather"):
        t8 = rng.standard_normal((N_SMALL + 1, 8), dtype=np.float32)
        t16 = rng.standard_normal((N_SMALL + 1, 16), dtype=np.float32)
        idx = rng.integers(0, N_SMALL, K_SMALL).astype(np.int32)
        (j8, p8), (j16, p16) = _pair(t8), _pair(t16, True)
        mag = (np.abs(t8[idx]).sum()
               + np.abs(p16.float().numpy()[idx]).sum())
        return (_data(k=K_SMALL, n=N_SMALL, tbl8=p8, tbl16=p16,
                      gidx=torch.from_numpy(idx).long()),
                (j8, j16, jnp.asarray(idx)), mag)
    if name in ("xla_transpose_only_psum", "pallas_transpose_both"):
        a8 = rng.standard_normal((K_SMALL, 8), dtype=np.float32)
        a16 = rng.standard_normal((K_SMALL, 16), dtype=np.float32)
        (j8, p8), (j16, p16) = _pair(a8), _pair(a16, True)
        mag = np.abs(a8).sum() + np.abs(p16.float().numpy()).sum()
        return _data(k=K_SMALL, a8=p8, a16=p16), (j8, j16), mag
    if name.startswith("scatter"):
        # positions across the module's K (the step's zeros), 0..2 included
        # so that the sum of the first 8 slots is not empty
        pos = np.unique(np.concatenate([
            [0, 1, 2], rng.choice(mod.K, N_SMALL, replace=False)]))
        pos = pos.astype(np.int32)
        if "int" in name:
            vals, mag = rng.integers(0, 1000, pos.size).astype(np.int32), None
            d = _data(k=mod.K, pos_i=torch.from_numpy(pos).long(),
                      vals_i=torch.from_numpy(vals))
        else:
            vals = rng.standard_normal(pos.size).astype(np.float32)
            mag = np.abs(vals[pos < 8]).sum()
            d = _data(k=mod.K, pos_f=torch.from_numpy(pos).long(),
                      vals_f=torch.from_numpy(vals))
        return d, (jnp.asarray(pos), jnp.asarray(vals)), mag
    # the searchsorted probes close over the module's K and N: its own CUM
    cum = np.array(mod.CUM)
    return (_data(k=mod.K, n=mod.N, cum=torch.from_numpy(cum)),
            (mod.CUM,), None)


@pytest.mark.parametrize("name", list(micro3.ALL))
def test_probe_step_matches_jax(jm3, name):
    mod, probes = jm3
    d, jargs, mag = _probe_inputs(mod, name)
    _, ref = probes[name][0](jargs, jnp.float32(0.0))
    step, args = micro3.ALL[name](d)
    with torch.no_grad():
        got = float(step(args))
    if mag is None:
        assert got == float(ref)
    else:
        assert abs(got - float(ref)) <= PROBE_RTOL * mag


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("fn,x,match", [
    (micro3.psum_consume, torch.zeros(((1 << 17) + 8, 8)), "multiple"),
    (micro3.psum_consume, torch.zeros((100, 8)), "multiple"),
    (micro3.psum_consume, torch.zeros((1 << 17, 8), dtype=torch.float64),
     "float32 or bfloat16"),
    (micro3.psum_consume, torch.zeros((2, 1 << 17, 8)), "2-D"),
    (micro3.psum_consume, _meta((1 << 17, 8)), "device"),
    (micro3.transpose, torch.zeros(((1 << 14) + 8, 8)), "multiple"),
    (micro3.transpose, torch.zeros((8, 1 << 14)), "multiple"),
    (micro3.transpose, torch.zeros((1 << 14, 65)), "64"),
    (micro3.transpose, torch.zeros((1 << 14, 8), dtype=torch.int32),
     "float32 or bfloat16"),
    (micro3.transpose, _meta((1 << 14, 8)), "device"),
])
def test_wrappers_refuse_what_jax_does_not_cover_whole(fn, x, match):
    n0 = fn.launches
    with pytest.raises(ValueError, match=match):
        fn(x)
    assert fn.launches == n0


def test_probes_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: micro3.run(["xla_searchsorted_control"]),
                 lambda: micro3.make_data(k=1 << 17, n=10)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
