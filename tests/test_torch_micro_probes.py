"""The port's glue micro-probes (vegs_torch/perf/micro.py) against the JAX
package's perf/micro_r02.py, micro2_r02.py, r03_micro.py and
r03_micro2.py, each loaded by path at K = 4,096 rows and N = 1,000
Gaussians (its module-level K and N rewritten before its arrays are
drawn) and run in this process on the CPU.

Each script's timer is replaced by a recorder of the jitted function and
its arguments; each function's jaxpr is then evaluated equation by
equation (`torch_jax_probes.intermediates`), since the scripts reduce
their arrays to a sum. Every array a port probe returns must equal one of
the values the JAX function computes on the same seeded data: to the bit
for gathers, sorts, searchsorted, scatters, transposes and integer
cumsums; within 1e-5 relative (of the array's largest magnitude, at
least 1) for the float sums of the segment reductions, whose order
differs. The seeded data is equal to the bit on both sides. The values a
port that did nothing could return (an input, a zero table, a slice of an
input) are not among those a line is held to, and each line's test that
plants such a port sees it refused.
"""

import numpy as np
import pytest
import torch

from tests.torch_jax_probes import (ACC0, as_numpy, assert_found,
                                    assert_refuses_noops, intermediates,
                                    load, recorder)
from vegs_torch.perf import micro

K_T, N_T = 4096, 1000
SIZE = [("\nK = 1 << 21", f"\nK = {K_T}"), ("\nN = 500_000", f"\nN = {N_T}")]
FLOAT_SUMS = {"segment_reduce_current_full", "segment_reduce_presorted",
              "jax_segment_sum_sorted"}
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _held(name, port_fn, values):
    with torch.no_grad():
        out = port_fn()
    assert_found(out, values, exact=name not in FLOAT_SUMS, rtol=RTOL,
                 what=name)


def _refuses_noops(name, d, port_fn, values):
    with torch.no_grad():
        out = port_fn()
    assert_refuses_noops(d, out, values, exact=name not in FLOAT_SUMS,
                         rtol=RTOL, what=name)


# -- micro_r02 ----------------------------------------------------------------


@pytest.fixture(scope="module")
def r02(tmp_path_factory):
    mod = load("micro_r02", tmp_path_factory.mktemp("jax_cache"), SIZE)
    # the probes' set-up draws, in ALL's order on both sides
    steps = {name: mod.ALL[name]() for name in mod.ALL}
    d = micro.r02_data("cpu", k=K_T, n=N_T)
    fns = {name: micro.R02[name](d) for name in micro.R02}
    values = {name: intermediates(*steps[name], ACC0) for name in steps}
    return mod, values, d, fns


def test_micro_r02_data_and_probes_match_jax(r02):
    mod, _, d, _ = r02
    assert list(micro.R02) == list(mod.ALL)
    for port, jax_name in (("perm", "PERM"), ("gidx", "GIDX"),
                           ("gidx_rand", "GIDX_RAND"), ("rows_k", "ROWS_K"),
                           ("rows_n", "ROWS_N")):
        np.testing.assert_array_equal(as_numpy(d[port]),
                                      as_numpy(getattr(mod, jax_name)))


@pytest.mark.parametrize("name", list(micro.R02))
def test_micro_r02_probe_matches_jax(r02, name):
    _, values, _, fns = r02
    _held(name, fns[name], values[name])


@pytest.mark.parametrize("name", list(micro.R02))
def test_micro_r02_probe_check_refuses_a_port_that_does_nothing(r02, name):
    _, values, d, fns = r02
    _refuses_noops(name, d, fns[name], values[name])


# -- micro2_r02, r03_micro, r03_micro2 ----------------------------------------


def _recorded(name, cache, monkeypatch):
    mod = load(name, cache, SIZE)
    calls, timeit = recorder()
    mod.timeit = timeit
    monkeypatch.setattr("sys.argv", [f"{name}.py"])
    mod.main()
    return calls


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    cache = tmp_path_factory.mktemp("jax_cache")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for group in ("micro2_r02", "r03_micro", "r03_micro2"):
            make, probes, _, _ = micro.GROUPS[group]
            d = make("cpu", k=K_T, n=N_T)
            fns = {p: probes[p](d) for p in probes}
            calls = _recorded(group, cache, mp)
            values = {p: intermediates(*calls[p], ACC0) for p in calls}
            out[group] = (calls, fns, values, d)
    return out


CASES = [(g, p) for g in ("micro2_r02", "r03_micro", "r03_micro2")
         for p in micro.GROUPS[g][1]]


def test_micro2_sections_and_lines_match_the_scripts(scripts):
    for group, (calls, fns, _, _) in scripts.items():
        assert list(calls) == list(fns), group
    assert sum(micro.R02B_SECTIONS.values(), []) == list(micro.R02B)


@pytest.mark.parametrize("group,name", CASES,
                         ids=[f"{g}:{p}" for g, p in CASES])
def test_micro_script_line_matches_jax(scripts, group, name):
    _, fns, values, _ = scripts[group]
    _held(name, fns[name], values[name])


@pytest.mark.parametrize("group,name", CASES,
                         ids=[f"{g}:{p}" for g, p in CASES])
def test_micro_script_line_check_refuses_a_port_that_does_nothing(
        scripts, group, name):
    _, fns, values, d = scripts[group]
    _refuses_noops(name, d, fns[name], values[name])


def test_select_takes_groups_and_probes():
    assert micro.select(micro.GROUPS, ["r03_micro2",
                                       "take_axis0_row24_2M"]) == {
        "micro_r02": ["take_axis0_row24_2M"],
        "r03_micro2": list(micro.R03B)}
    assert sum(len(v) for v in micro.select(micro.GROUPS).values()) == 39
    with pytest.raises(ValueError, match="no such probe"):
        micro.select(micro.GROUPS, ["nope"])


def test_run_on_the_cpu_times_every_line_on_the_host():
    lines = []
    res = micro.run(["copy", "binning", "lax.sort 2-operand [K]"],
                    device="cpu", iters=1, warmup=0,
                    sizes={g: (K_T, N_T) for g in micro.GROUPS},
                    emit=lambda **kw: lines.append(kw))
    assert [ln["line"] for ln in lines] == [
        "copy [2M,8] f32 (control)", *micro.R02B_SECTIONS["binning"],
        "lax.sort 2-operand [K]", "lax.sort 2-operand [K]"]
    assert all("cpu_ms" in ln and "ms" not in ln for ln in lines)
    assert res["card"] == "cpu"
