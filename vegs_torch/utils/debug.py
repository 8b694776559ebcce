"""Numerical-health auditing (port of vegs_tpu/utils/debug.py).

`checked(fn)` runs `fn` under a `TorchDispatchMode` that looks at every
operator's floating-point outputs and raises on the first non-finite one,
naming the operator (the counterpart of JAX's checkify float checks);
`assert_all_finite` audits a nested dict, list or tuple of tensors or
arrays on the host; `nan_guard` replaces NaNs with zeros (and infinities
with the largest finite values, as `torch.nan_to_num` and JAX's
`jnp.nan_to_num` do) across such a tree.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"{func} produced {int((~torch.isfinite(t)).sum())} "
                    f"non-finite values of {t.numel()}")
        return out


def checked(fn: Callable) -> Callable:
    """Wrap `fn` so the first operator inside it that produces a NaN or an
    infinity raises FloatingPointError naming that operator. Usage:

        step = debug.checked(train_step)
        out = step(...)
    """

    def wrapper(*args, **kwargs):
        with _NonFiniteCheck():
            return fn(*args, **kwargs)

    return wrapper


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError listing every leaf of a nested dict, list or
    tuple whose floating-point values are not all finite."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            bad.append(f"{path}: {n_bad}/{arr.size} non-finite")
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}:\n  " + "\n  ".join(bad))


def nan_guard(tree):
    """`torch.nan_to_num(x, nan=0.0)` on every floating-point tensor of a
    nested dict, list or tuple; other leaves pass through."""
    return tree_map(
        lambda x: torch.nan_to_num(x, nan=0.0)
        if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
        tree)
