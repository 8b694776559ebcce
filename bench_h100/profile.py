"""The traced window's arithmetic: torch.profiler's device operations
(kernels, copies, fills), their union as the device's busy time, device
time by operation name, and the idle gaps named by what the host was
running when each began."""

from __future__ import annotations

import bisect
import time
from typing import Callable, NamedTuple

import torch

# the program's hand-written kernels (vegs_torch/csrc), by kernel name
KERNELS = {"K1": ("blend_fwd_kernel",), "K2": ("blend_bwd_kernel",),
           "K3": ("segreduce_kernel", "rows_kernel"),
           "K4": ("satcount_kernel",)}


class Trace(NamedTuple):
    wall_s: float
    ops: list    # (name, start_us, end_us) of each device operation
    host: list   # (start_us, end_us, name) of each host operation

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.ops)) / 1e6

    def device_s(self, pred=lambda name: True) -> float:
        return sum(e - s for n, s, e in self.ops if pred(n)) / 1e6

    def by_name(self) -> dict:
        out = {}
        for n, s, e in self.ops:
            out[n] = out.get(n, 0.0) + (e - s) / 1e6
        return out


def kernel_of(name: str):
    """The hand-written kernel ("K1".."K4") a device operation is, or None."""
    return next((k for k, keys in KERNELS.items()
                 if any(s in name for s in keys)), None)


def union(ops) -> list:
    """Merged [start, end] intervals of the operations (microseconds)."""
    out = []
    for s, e in sorted((s, e) for _, s, e in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def record(fn: Callable[[], None], dev, host: bool = False) -> Trace:
    """Run `fn` under torch.profiler, ending in a synchronize, and collect
    its operations: the device's alone (tracing the host's operations too,
    with `host`, costs some tens of microseconds an operation, which would
    read as idle device time)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(dev).type == "cuda"
    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, host = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if kernel_of(e.name) or not e.name.startswith("vegs::"):
                ops.append((e.name, r.start, r.end))
        else:
            host.append((r.start, r.end, e.name))
    return Trace(wall, ops, sorted(host))


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """The idle time between device operations, summed by the innermost
    host operation running when each gap began, largest first."""
    spans = union(tr.ops)
    starts = [h[0] for h in tr.host]
    by = {}
    for (_, e0), (s1, _) in zip(spans[:-1], spans[1:]):
        gap = s1 - e0
        i = bisect.bisect_right(starts, e0)
        name, best = "host: no operation", None
        for s, e, n in tr.host[max(0, i - 400):i]:
            if s <= e0 < e and (best is None or e - s < best):
                name, best = n, e - s
        by[name] = by.get(name, 0.0) + gap / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def breakdown(tr: Trace, host_tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in `tr`, and the longest
    idle gaps of `host_tr` (traced with the host) by what the host ran."""
    ops = sorted(([k[:120], v] for k, v in tr.by_name().items()),
                 key=lambda kv: -kv[1])[:top]
    return {"device_ops": ops, "idle_gaps": idle_gaps(host_tr, top)}
