"""The port's gather-backward probes (vegs_torch/perf/gebwd.py) against the
JAX package's perf/r04_gebwd.py, r05_gebwd2.py, r05_segreduce.py and
r05_segreduce2.py, on the CPU at K = 4,096 rows and N = 1,001 segments
(1,000 for r04; NG = 1,024, a multiple of the JAX contract's 512, so the
Pallas segment reduce runs in interpret mode).

  * r05_gebwd2 and r05_segreduce2 load: each script's module-level K and
    N are rewritten, its timer replaced by a recorder, and every array a
    port line returns must equal one of the values its JAX function
    computes on the same seeded data (`torch_jax_probes.intermediates`):
    to the bit for the gathers, packs and transposes; within 1e-5
    relative (of the largest magnitude, at least 1) for the float sums,
    and one bf16 step (2^-7 relative) on the bf16 outputs rounded from
    them. The values a port that did nothing could return (an input, a
    zero table, a slice of an input) are not among those a line is held
    to, and each line's test that plants such a port sees it refused.
  * r04_gebwd.py and r05_segreduce.py do not import: `_gather3x8` and
    `segment_reduce_rows` are not in the JAX package. Their lines are held
    against the JAX functions that remain, on the port's seeded data:
    `micro.gather3x8` against micro_r02's own `ga` lambda (taken from its
    code), `gebwd.gather_rows_aux` against `_gather_rows_aux`, the blocked
    cumsum against `_blocked_cumsum`, the sort and scatter inversions
    against `lax.sort` and `.at[].set`, the bf16 boundary gather against
    r04_gebwd.py:66-69's expression; and r05_segreduce's two lines --
    `seg_only` (the packed rows unpacked and summed per segment) and
    `full_new` (`segreduce.gather_expand_bwd`) -- against the VJP of
    `vegs_tpu.ops.rasterize.gather_expand` on the same integer cotangents,
    with dead rows and padded empty segments: equal to the bit, every sum
    exact in float32 and in bf16.
  * `unpack_to_cm` against rasterize.py's `_unpack_to_cm`, bit for bit, on
    random int32 rows (NaN payloads included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_probes import (ACC0, as_numpy, assert_found,
                                    assert_refuses_noops, inner_function,
                                    intermediates, load, recorder)
from vegs_torch.ops import segreduce
from vegs_torch.perf import gebwd, micro

K_T, N_T = 4096, 1001
SIZES = {"r04_gebwd": (K_T, 1000), "r05_gebwd2": (K_T, N_T),
         "r05_segreduce": (K_T, N_T), "r05_segreduce2": (K_T, N_T)}
FLOAT_SUMS = {"XLA segment path (cumsum + boundary gather + diff)",
              "FULL current _ge_bwd (gathers+mask+segment)",
              "seg_only (K3: segment_reduce_cols)",
              "full_new (pack+gather+unpackT+K3)",
              "blocked cumsum [K,24] f32"}
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(group, name):
    make, probes, _, _ = gebwd.GROUPS[group]
    d = make("cpu", *SIZES[group])
    with torch.no_grad():
        return d, probes[name](d)()


# -- the scripts that load ----------------------------------------------------


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    cache = tmp_path_factory.mktemp("jax_cache")
    out = {}
    for group, subs in (
            ("r05_gebwd2", [("\nK = 1126912", f"\nK = {K_T}"),
                            ("\nN = 500_001", f"\nN = {N_T}")]),
            ("r05_segreduce2", [("\nK = 1126912", f"\nK = {K_T}"),
                                ("\nN1 = 500_001", f"\nN1 = {N_T}")])):
        mod = load(group, cache, subs)
        calls, timeit = recorder()
        mod.timeit = timeit
        mod.main()
        out[group] = (calls, {name: intermediates(fn, args, ACC0)
                              for name, (fn, args) in calls.items()})
    return out


CASES = [(g, p) for g in ("r05_gebwd2", "r05_segreduce2")
         for p in gebwd.GROUPS[g][1]]


def test_loaded_scripts_time_the_ported_lines(loaded):
    assert list(loaded["r05_gebwd2"][0]) == list(gebwd.R05B)
    assert len(loaded["r05_segreduce2"][0]) == len(gebwd.R05S2) == 2


def _values(loaded, group, name):
    calls, values = loaded[group]
    return values[name if group == "r05_gebwd2"
                  else list(calls)[list(gebwd.R05S2).index(name)]]


@pytest.mark.parametrize("group,name", CASES,
                         ids=[f"{g}:{p}" for g, p in CASES])
def test_gebwd_line_matches_jax(loaded, group, name):
    _, out = _port(group, name)
    assert_found(out, _values(loaded, group, name),
                 exact=name not in FLOAT_SUMS, rtol=RTOL, what=name)


@pytest.mark.parametrize("group,name", CASES,
                         ids=[f"{g}:{p}" for g, p in CASES])
def test_gebwd_line_check_refuses_a_port_that_does_nothing(loaded, group,
                                                           name):
    d, out = _port(group, name)
    assert_refuses_noops(d, out, _values(loaded, group, name),
                         exact=name not in FLOAT_SUMS, rtol=RTOL, what=name)


def test_segreduce2_spans_have_empty_padding_segments():
    d = gebwd.r05s2_data("cpu", *SIZES["r05_segreduce2"])
    ends, starts = d["ends"], d["starts"]
    assert ends.shape[0] == gebwd.ng_of(N_T) == 1024
    assert torch.equal(starts[1:], ends[:-1]) and int(starts[0]) == 0
    assert torch.all(ends[N_T:] == ends[N_T - 1])
    assert torch.all(ends[N_T:] == starts[N_T:])   # empty
    # full bench shape: 500,224 segments, the last 223 empty
    assert gebwd.ng_of(gebwd.N5) - gebwd.N5 == 223


# -- the scripts that do not load ---------------------------------------------


@pytest.mark.parametrize("group,missing", [("r04_gebwd", "_gather3x8"),
                                           ("r05_segreduce",
                                            "segment_reduce_rows")])
def test_stale_jax_scripts_fail_to_import(tmp_path, group, missing):
    with pytest.raises(ImportError, match=missing):
        load(group, tmp_path)


@pytest.fixture(scope="module")
def ga(tmp_path_factory):
    """micro_r02.py:168's `ga` lambda, the definition `_gather3x8` had."""
    mod = load("micro_r02", tmp_path_factory.mktemp("jax_cache"),
               [("\nK = 1 << 21", "\nK = 512"), ("\nN = 500_000", "\nN = 64")])
    return inner_function(mod.r_presorted_segment_reduce, "step", "<lambda>")


def _jax(d, name):
    x = d[name]
    return jnp.asarray(as_numpy(x)).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else
        jnp.float32 if x.is_floating_point() else jnp.int32)


def _r04_reference(name, d, ga):
    from vegs_tpu.ops.rasterize import _blocked_cumsum, _gather_rows_aux

    pad = lambda x: jnp.pad(x, ((0, 8), (0, 0)))  # noqa: E731
    order, ends = _jax(d, "order"), _jax(d, "ends")
    d_pf, d_pa = _jax(d, "d_pf"), _jax(d, "d_pa")
    cum24, g24 = _jax(d, "cum24"), _jax(d, "g24")
    k = d.k
    if name == "reorder gather f32 row-8 [K]":
        return pad(d_pf)[order]
    if name == "reorder gather bf16-as-int32 row-8 [K]":
        return _gather_rows_aux(pad(d_pa), order)
    if name == "blocked cumsum [K,24] f32":
        return _blocked_cumsum(g24)
    if name == "boundary gather3x8 [N] of [K+1,24]":
        return ga(cum24, ends)
    if name == "fused bf16 gather row-8-int32 (16 cols) [K]":
        all16 = jnp.concatenate([d_pf.astype(jnp.bfloat16), d_pa[:, :8]], 1)
        return _gather_rows_aux(pad(all16), order)
    if name == "boundary gather [N] rows-12-bf16 (as 6xint32)":
        cum12a = cum24[:, :12].astype(jnp.bfloat16)
        return jax.lax.bitcast_convert_type(jax.lax.bitcast_convert_type(
            cum12a.reshape(k + 1, 6, 2), jnp.int32)[ends],
            jnp.bfloat16).astype(jnp.float32)
    if name == "reorder gather f32 row-24 [K] (3x8 pieces)":
        return ga(pad(g24), order)
    perm, vals = _jax(d, "perm"), _jax(d, "vals")
    if name == "perm-invert via 2-op sort [K]":
        return jax.lax.sort((perm, vals), num_keys=1)[1]
    assert name == "perm-invert via unique scatter [K]"
    return jnp.zeros((k,), jnp.int32).at[perm].set(vals, unique_indices=True)


@pytest.mark.parametrize("name", list(gebwd.R04))
def test_r04_line_matches_the_remaining_jax_functions(ga, name):
    d, out = _port("r04_gebwd", name)
    got = as_numpy(out)
    # the bf16 boundary gather comes back [N + 1, 6, 2] from its bitcasts
    want = as_numpy(_r04_reference(name, d, ga)).reshape(got.shape)
    if name == "blocked cumsum [K,24] f32":
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_gather3x8_is_micro_r02_ga(ga):
    rng = np.random.default_rng(3)
    t = rng.normal(size=(600, 24)).astype(np.float32)
    i = rng.integers(0, 600, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        micro.gather3x8(torch.from_numpy(t), torch.from_numpy(i).long()),
        np.asarray(ga(jnp.asarray(t), jnp.asarray(i))))


def _integer_case(seed=0):
    """r05_segreduce's layout with integer cotangents: [K, 8] f32 and
    [K, 16] bf16 in [-4, 4], an order with dead rows (>= K), N_T sorted
    random ends padded to NG with the last."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(K_T + 64)[:K_T].astype(np.int32)
    ends, starts = gebwd._spans(rng, K_T, N_T)
    d_pf = rng.integers(-4, 5, (K_T, 8)).astype(np.float32)
    d_pa = rng.integers(-4, 5, (K_T, 16)).astype(np.float32)
    return order, ends, starts, d_pf, d_pa


def test_r05_segreduce_lines_equal_the_jax_gather_vjp():
    from vegs_tpu.ops.rasterize import gather_expand

    order, ends, starts, d_pf, d_pa = _integer_case()
    ng = ends.shape[0]
    pf0 = jnp.zeros((ng, 8), jnp.float32)
    pa0 = jnp.zeros((ng, 16), jnp.bfloat16)
    gidx = jnp.zeros((K_T,), jnp.int32)
    _, vjp = jax.vjp(lambda a, b: gather_expand(a, b, gidx, jnp.asarray(order),
                                                jnp.asarray(ends)), pf0, pa0)
    j_pf, j_pa = vjp((jnp.asarray(d_pf), jnp.asarray(d_pa, jnp.bfloat16)))
    j_pf, j_pa = np.asarray(j_pf), as_numpy(j_pa)
    assert np.abs(j_pa).max() < 256   # the sums are exact in bf16
    assert np.count_nonzero(j_pf) > 0

    t_pf = torch.from_numpy(d_pf)
    t_pa = torch.from_numpy(d_pa).to(torch.bfloat16)
    t_order = torch.from_numpy(order)
    d = micro.Data(None, "cpu", K_T, N_T, ends=ends, starts=starts)
    d["packed"] = gebwd.masked_gather(gebwd.pack_rows(t_pf, t_pa), t_order)
    d["d_pf_t"] = t_pf.t().contiguous()
    d["d_pa_t"] = t_pa.t().contiguous()
    d["order"] = t_order
    seg = gebwd.R05S[gebwd.SEG_ONLY_ROWS](d)()
    np.testing.assert_array_equal(seg[:, :8].numpy(), j_pf)
    np.testing.assert_array_equal(seg[:, 8:].numpy(), j_pa)
    f, a = gebwd.R05S["full_new (K3: gather_expand_bwd)"](d)()
    assert a.dtype == torch.bfloat16
    assert f.is_contiguous() and a.is_contiguous()
    np.testing.assert_array_equal(f.numpy(), j_pf)
    np.testing.assert_array_equal(as_numpy(a), j_pa)
    # and the same sums through K3's JAX contract on the unpacked columns
    cols = gebwd.unpack_to_cm(d["packed"])
    out = segreduce.segment_reduce_cols(cols, d["starts"], d["ends"])
    np.testing.assert_array_equal(out.T.numpy(), np.concatenate([j_pf, j_pa],
                                                                1))


def test_unpack_to_cm_matches_jax_bit_for_bit():
    from vegs_tpu.ops.rasterize import _unpack_to_cm

    rng = np.random.default_rng(5)
    g = rng.integers(-2**31, 2**31, (1024, 16)).astype(np.int64).astype(
        np.int32)
    got = gebwd.unpack_to_cm(torch.from_numpy(g))
    want = _unpack_to_cm(jnp.asarray(g), 1024)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  np.asarray(jax.lax.bitcast_convert_type(
                                      want, jnp.int32)))
    rows = gebwd.unpack_rows(torch.from_numpy(g))
    np.testing.assert_array_equal(
        rows.T.contiguous().view(torch.int32).numpy(),
        got.view(torch.int32).numpy())
