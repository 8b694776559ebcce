"""Helpers for holding the port's probe modules (vegs_torch/perf/) against
the JAX package's perf/ scripts at a toy size.

`load` executes a script from perf/ as a module with some of its constants
rewritten in its source (its module-level arrays are drawn at import, so
the size is set before they are), restoring the environment and sys.path
its import changes. `recorder` stands in for a script's timer and keeps
each line's jitted function and arguments. `intermediates` evaluates a
function's jaxpr equation by equation and returns the values that are the
line's work (the scripts reduce each line's arrays to a sum inside the
timed loop, so the arrays are read there, not from the sum): not an input
again, not a fill, not a slice or cast of inputs. `assert_found` holds a
port array to one of those values, of its shape; `assert_refuses_noops`
shows that a port line returning zeros or one of its inputs would fail.
"""

from __future__ import annotations

import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax._src import core as jcore

ROOT = Path(__file__).resolve().parents[1]
ACC0 = jnp.float32(0.0)  # the timing loops' carried accumulator


def load(name: str, cache_dir, subs=()) -> types.ModuleType:
    """perf/<name>.py as a module, each (old, new) of `subs` replaced once
    in its source before it runs."""
    path = ROOT / "perf" / f"{name}.py"
    source = path.read_text()
    for old, new in subs:
        if old not in source:
            raise AssertionError(f"{name}: {old!r} not in the script")
        source = source.replace(old, new, 1)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    env, syspath = dict(os.environ), list(sys.path)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    try:
        exec(compile(source, str(path), "exec"), mod.__dict__)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = syspath
    return mod


def recorder():
    """(calls, timeit): timeit(name, fn, args, ...) keeps (fn, args) under
    the stripped name and times nothing."""
    calls = {}

    def timeit(name, fn, args, *rest, **kw):
        calls[name.strip()] = (fn, args)
        return 0.0
    return calls, timeit


# Primitives that only move, cast or rearrange the values they are given.
# A value they make from a script's inputs alone is not the work of a line.
VIEWS = {"slice", "reshape", "squeeze", "expand_dims", "convert_element_type",
         "bitcast_convert_type", "concatenate", "broadcast_in_dim", "pad",
         "copy", "copy_p", "rev"}
# Primitives that reorder, combine or select rows: the work the probes
# time. A value that still feeds one of them is a stage of its line, not
# what the line returns.
WORK = {"gather", "scatter", "scatter-add", "sort", "cumsum", "cummax",
        "cumprod", "transpose", "dot_general", "dynamic_slice",
        "dynamic_update_slice", "pjit", "closed_call", "custom_jvp_call",
        "custom_vjp_call", "custom_vjp_call_jaxpr", "pallas_call", "while",
        "scan", "cond"}


def intermediates(fn, *args) -> list:
    """The values `fn(*args)` computes that are the work of the line, as
    numpy: the outputs of each equation of its jaxpr, evaluated in order,
    less every value a port that did nothing, or stopped half-way, could
    also return. Left out are the values equal to an input or a constant
    of the jaxpr (the scripts' `dep(x, acc)` is `x` again at acc = 0), the
    fills (a zero table, a broadcast scalar), what VIEWS make of such
    values alone (a slice or a cast of an input), and the stages: values
    that still feed a WORK equation (the pack a gather then reads)."""
    closed = jax.make_jaxpr(fn)(*args)
    jaxpr = closed.jaxpr
    env = {}
    given = [as_numpy(c) for c in closed.consts]
    given += [as_numpy(a) for a in jax.tree_util.tree_leaves(args)]
    trivial = set()

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    def same_as_given(o):
        return any(g.size == o.size and g.dtype.kind == o.dtype.kind and
                   np.array_equal(g.ravel(), o.ravel(),
                                  equal_nan=o.dtype.kind == "f")
                   for g in given)

    for v, c in zip(jaxpr.constvars, closed.consts):
        env[v] = c
        trivial.add(v)
    for v, a in zip(jaxpr.invars, jax.tree_util.tree_leaves(args)):
        env[v] = a
        trivial.add(v)
    stages = set()
    for eqn in reversed(jaxpr.eqns):
        if eqn.primitive.name in WORK or any(o in stages
                                             for o in eqn.outvars):
            stages.update(v for v in eqn.invars
                          if not isinstance(v, jcore.Literal))
    values = []
    for eqn in jaxpr.eqns:
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        out = eqn.primitive.bind(*subfuns, *map(read, eqn.invars), **params)
        outs = out if eqn.primitive.multiple_results else [out]
        moved = eqn.primitive.name in VIEWS and all(
            isinstance(v, jcore.Literal) or v in trivial for v in eqn.invars)
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
            a = as_numpy(o)
            fill = a.size <= 1 or bool(np.all(a.ravel() == a.ravel()[0]))
            if moved or fill or same_as_given(a) or v in stages:
                trivial.add(v)
            else:
                values.append(a)
    return values


def as_numpy(x) -> np.ndarray:
    """A JAX or torch array as numpy: floats as float32 (bf16 widened),
    integers as int64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = x.float() if x.is_floating_point() else x.long()
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32 if a.dtype.kind in "fV" or
                    a.dtype == jnp.bfloat16 else np.int64)


def _blocked(p, j) -> bool:
    """j's shape is p's, or p's with its first axis split into blocks (the
    scripts' blocked cumsums: [K, 8] as [K / 512, 512, 8])."""
    lead = j.ndim - p.ndim + 1
    return p.shape == j.shape or (
        p.ndim >= 1 and lead > 1 and j.shape[lead:] == p.shape[1:] and
        int(np.prod(j.shape[:lead])) == p.shape[0])


def _matches(p, j, exact, rtol):
    if p.dtype.kind != j.dtype.kind or not _blocked(p, j):
        return False
    p = p.reshape(j.shape)
    if exact:
        return np.array_equal(p, j, equal_nan=p.dtype.kind == "f")
    scale = max(float(np.abs(p).max(initial=0.0)), 1.0)
    return np.allclose(p, j, rtol=rtol, atol=rtol * scale)


def assert_found(port, values, exact: bool, rtol: float, what: str):
    """Each array of `port` (a tensor or a tuple of them) equals (exact)
    or is within `rtol` (of itself and of its largest magnitude) of a
    value in `values` of its shape (or of its shape with the first axis
    split into blocks); bf16 arrays are widened."""
    for i, t in enumerate(port if isinstance(port, tuple) else (port,)):
        p = as_numpy(t)
        bf16 = t.dtype == torch.bfloat16 and not exact
        r = max(rtol, 2.0 ** -7) if bf16 else rtol
        if not any(_matches(p, j, exact, r) for j in values):
            near = sum(_blocked(p, j) for j in values)
            raise AssertionError(f"{what}: output {i} {p.shape} {t.dtype} "
                                 f"matches none of the {near} JAX values "
                                 f"of its shape")


def noops(arrays, out):
    """(i, array): what a port line that did nothing could return in place
    of the i-th array of `out` -- zeros, or one of `arrays` (the line's
    inputs by name) in its shape."""
    for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
        yield i, torch.zeros_like(t)
        for x in arrays.values():
            if (x.numel() == t.numel() and
                    x.is_floating_point() == t.is_floating_point()):
                yield i, x.reshape(t.shape).to(t.dtype)


def assert_refuses_noops(arrays, out, values, exact, rtol, what):
    """`assert_found` refuses `out` with any one of its arrays replaced by
    a no-op's (`noops`)."""
    outs = out if isinstance(out, tuple) else (out,)
    planted = 0
    for i, fake in noops(arrays, out):
        bad = outs[:i] + (fake,) + outs[i + 1:]
        try:
            assert_found(bad, values, exact, rtol, what)
        except AssertionError as e:
            assert "matches none" in str(e), e
        else:
            raise AssertionError(f"{what}: a no-op's output {i} "
                                 f"{tuple(fake.shape)} passed")
        planted += 1
    assert planted >= len(outs)


def inner_function(fn, *names):
    """The function whose code is nested in `fn` under `names` (a chain of
    code object names), with `fn`'s globals: a closure-free local such as
    micro_r02's `ga` lambda."""
    code = fn.__code__
    for name in names:
        code = next(c for c in code.co_consts
                    if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, fn.__globals__)
