"""Spans and counters of the port's work, read against torch.profiler.

`span(name, sync=False)` marks a stretch of the program's host code and
`count(name, n=1)` adds to an integer counter. Both are off unless a
torch.profiler session is running (`torch.autograd.profiler.
_is_profiler_enabled`, which every session sets, the device-only ones
too): off, `span` returns one shared null context and `count` returns at
once, with no allocation and no CUDA call.

On, a span opens `record_function("vegs::" + name)`, so a trace that
records the host shows it on the profiler's clock, and appends a record:
its name, its parent, its unit, its host start and end (`perf_counter_ns`)
and, where CUDA is initialized, two pooled timing events recorded as it
opens and closes on the stream current when its unit opened, which place
it on the device's timeline in stream order. `sync=True` marks a span
that blocks the host on the device (a read to the host, `nonzero` or a
boolean mask's index, a copy from pageable memory) or may (a staging
buffer's wait for its previous copy).

A unit is one `train.step` or `video.frame` (`UNITS`) opened outside any
other unit. While one is open the host's syncs are counted as they
happen: CUDA's sync debug mode warns of each synchronizing call, and each
such warning, instead of being shown, adds one to the unit's `host_sync`
count, and one to `host_sync.unspanned.<span>` where no sync span is open
(`<span>` the innermost open one). A counter counts only what the host
already holds: it never reads a device value.

Spans and counts outside a unit are not kept; the recorder keeps the
MAX_UNITS most recent units. `recorded()` returns them with their device
times resolved, in microseconds from unit 0's opening. Spans nest on one
host thread.

`trace_steps(log_dir)` is the operator's trace: a torch.profiler session
written for TensorBoard, where the `vegs::` spans show beside the device's
operations.
"""

from __future__ import annotations

import collections
import time
import warnings
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

UNITS = ("train.step", "video.frame")
MAX_UNITS = 64
# the start of the warning CUDA's sync debug mode gives at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"

_NULL = nullcontext()


class Span(NamedTuple):
    """One recorded span. `parent` indexes the unit's spans (None for the
    unit's own span, spans[0]); `sync` whether it blocks the host on the
    device; device times are microseconds from unit 0's opening, None
    without CUDA."""

    name: str
    parent: Optional[int]
    sync: bool
    host_start_ns: int
    host_end_ns: int
    start_us: Optional[float] = None
    end_us: Optional[float] = None


class Unit(NamedTuple):
    index: int    # units opened before it since the recorder was reset
    spans: list   # [Span], spans[0] the unit's own
    counts: dict  # counter name -> int


class _Rec:
    __slots__ = ("name", "parent", "sync", "t0", "t1", "ev0", "ev1")

    def __init__(self, name, parent, sync):
        self.name, self.parent, self.sync = name, parent, sync
        self.t1 = 0
        self.ev0 = self.ev1 = None


class _Watch:
    """The open unit's sync count: CUDA's sync debug mode set to warn
    (where CUDA is initialized and the mode is off), and its warnings
    counted (`_synced`) in place of being shown; every other warning is
    shown as before."""

    def __init__(self):
        self.saved = warnings.catch_warnings()
        self.saved.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.shown = warnings.showwarning
        warnings.showwarning = self.show
        self.set = (torch.cuda.is_initialized()
                    and torch.cuda.get_sync_debug_mode() == 0)
        if self.set:
            torch.cuda.set_sync_debug_mode("warn")

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        if str(message).startswith(SYNC_WARNING):
            _synced()
        else:
            self.shown(message, category, filename, lineno, file, line)

    def close(self):
        if self.set:
            torch.cuda.set_sync_debug_mode(0)
        self.saved.__exit__(None, None, None)


class _Recorder:
    def __init__(self):
        self.units = collections.deque()  # closed: (index, [_Rec], counts)
        self.unit = None                  # the open unit, or None
        self.stack = []                   # indexes of the open spans
        self.opened = 0
        self.pool = []                    # free timing events
        self.stream = None                # the open unit's CUDA stream
        self.watch = None                 # the open unit's `_Watch`

    def event(self):
        ev = self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)
        ev.record(self.stream)
        return ev

    def release(self, recs):
        self.pool += [e for r in recs for e in (r.ev0, r.ev1) if e is not None]

    def open_unit(self):
        self.unit = (self.opened, [], {})
        self.opened += 1
        self.stream = (torch.cuda.current_stream()
                       if torch.cuda.is_initialized() else None)
        self.watch = _Watch()

    def close_unit(self):
        self.watch.close()
        self.watch = None
        self.units.append(self.unit)
        self.unit = None
        while len(self.units) > MAX_UNITS:
            self.release(self.units.popleft()[1])


_R = _Recorder()


def _synced() -> None:
    """One host sync in the open unit."""
    r = _R
    if r.unit is None:
        return
    count("host_sync")
    recs = r.unit[1]
    if not any(recs[i].sync for i in r.stack):
        count("host_sync.unspanned." + recs[r.stack[-1]].name)


class _Open:
    """A span while a profiler session runs."""

    __slots__ = ("name", "sync", "rec", "fn")

    def __init__(self, name: str, sync: bool):
        self.name, self.sync = name, sync
        self.rec = None

    def __enter__(self):
        self.fn = _profiler.record_function("vegs::" + self.name)
        self.fn.__enter__()
        r = _R
        if r.unit is None and self.name in UNITS:
            r.open_unit()
        if r.unit is not None:
            recs = r.unit[1]
            rec = _Rec(self.name, r.stack[-1] if r.stack else None,
                       bool(self.sync))
            r.stack.append(len(recs))
            recs.append(rec)
            self.rec = rec
            rec.t0 = time.perf_counter_ns()
            if r.stream is not None:
                rec.ev0 = r.event()
        return self

    def __exit__(self, *exc):
        rec, r = self.rec, _R
        if rec is not None and r.stack:  # (not forgotten by `reset`)
            if rec.ev0 is not None:
                rec.ev1 = r.event()
            rec.t1 = time.perf_counter_ns()
            r.stack.pop()
            if not r.stack:
                r.close_unit()
        self.fn.__exit__(*exc)
        return False


def span(name: str, sync: bool = False):
    """A context manager marking `name`; `sync` where it blocks the host
    on the device. Off (the shared null context) unless a profiler session
    is running."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, sync)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the open unit's counter `name` (while a profiler session
    runs; nothing outside a unit)."""
    if _profiler._is_profiler_enabled and _R.unit is not None:
        counts = _R.unit[2]
        counts[name] = counts.get(name, 0) + n


def reset() -> None:
    """Forget every recorded unit (an open one included)."""
    _R.release([rec for u in _R.units for rec in u[1]])
    if _R.unit is not None:
        _R.release(_R.unit[1])
        _R.watch.close()
    _R.units.clear()
    _R.unit, _R.stack, _R.opened, _R.watch = None, [], 0, None


def recorded(units: Optional[int] = None) -> list:
    """The closed units (the first `units` of them), oldest first, as
    `Unit`s. Device times are resolved from the timing events (this waits
    for the last of them) in microseconds from unit 0's opening."""
    done = list(_R.units)[:units]
    if not done:
        return []
    ref = done[0][1][0].ev0
    if ref is not None:
        done[-1][1][0].ev1.synchronize()

    def dev(ev):
        return (None if ev is None or ref is None
                else 1e3 * ref.elapsed_time(ev))

    return [Unit(i, [Span(r.name, r.parent, r.sync, r.t0, r.t1, dev(r.ev0),
                          dev(r.ev1)) for r in recs], dict(c))
            for i, recs, c in done]


def trace_steps(log_dir: str):
    """A context manager that profiles what runs inside it (the host, and
    the card's operations when there is one) and writes the trace, the
    `vegs::` spans with it, for TensorBoard's profiler plugin into
    `log_dir`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)))
