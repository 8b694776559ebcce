"""The program's own spans and counters in a traced run, for the per-layer
metrics that read them: the device-traced units that
`vegs_torch.utils.trace` recorded (the first `r.units`; the host-traced
units after them are not read), their spans placed on `r.trace`'s clock
(`align`), and the device's busy and idle time inside them. Where the
program has no such module, the trace holds no device operation (the
CPU), or the placement fails (`units`), each reader returns None.

    python -m bench_h100.spans --workload <cell> --seed <n> [--seconds <s>]

runs the cell's loop on the card with tracing and prints one JSON line: the
new metrics, the counters a unit, the busy, idle and sync-idle ms a unit
of each stage (each span directly under a unit's own) and of what lies in
none, the placement's check (`edges`), the host ms a traced unit with the
spans on, with `span` patched to the null context and with the sync
count's watch patched out (sessions in turns), the cost of one span off
and on, and of one sync plain and counted."""

from __future__ import annotations

import bisect
import json
import statistics
import sys
import time

from .align import align, misses
from .profile import union

# how far (microseconds) a device operation may lie outside its unit's
# extent, and a sync span's extent is widened on each side: the timing
# events run within some microseconds of the operations beside them
EDGE_US = 20.0


def aligned(r):
    """The device-traced units with device times on `r.trace`'s clock, or
    None where there are none."""
    if not r.trace.ops:
        return None
    if not hasattr(r, "aligned_units"):  # one alignment for every reader
        try:
            from vegs_torch.utils import trace
        except ImportError:
            return None
        got = trace.recorded(units=r.units)
        r.aligned_units = (
            align(got, r.trace.ops) if len(got) >= r.units and all(
                s.start_us is not None for u in got for s in u.spans)
            else None)
    return r.aligned_units


def _crossing(ops, us) -> tuple:
    """([name, unit, start less the unit's opening, end less its closing]
    of each device operation that crosses a unit's edge by more than
    EDGE_US, device microseconds between units)."""
    ext = [(u.spans[0].start_us, u.spans[0].end_us) for u in us]
    cross, outside = [], 0.0
    for name, s, e in ops:
        if any(a - EDGE_US <= s and e <= b + EDGE_US for a, b in ext):
            continue
        hit = [(k, a, b) for k, (a, b) in enumerate(ext) if s < b and e > a]
        if hit:
            k, a, b = hit[0]
            cross.append([name[:60], k, s - a, e - b])
        else:
            outside += e - s
    return cross, outside


def units(r):
    """The aligned units (`aligned`), or None, also where the alignment
    failed: a device operation crosses a unit's edge, a host-device copy
    inside a unit lies in no sync span, or a sync span of a unit after the
    first holds no copy (`align.misses`). No reading, rather than a wrong
    one."""
    us = aligned(r)
    if us is None:
        return None
    if not hasattr(r, "failed"):
        r.failed = bool(_crossing(r.trace.ops, us)[0]
                        or any(misses(us, r.trace.ops)))
    return None if r.failed else us


class Busy:
    """The merged intervals of a trace's device operations (microseconds)."""

    def __init__(self, ops):
        self.spans = union(ops)
        self.starts = [s for s, _ in self.spans]

    def _first(self, a: float) -> int:
        return max(bisect.bisect_right(self.starts, a) - 1, 0)

    def within(self, a: float, b: float) -> float:
        """Busy microseconds inside [a, b]."""
        t = 0.0
        for s, e in self.spans[self._first(a):]:
            if s >= b:
                break
            t += max(0.0, min(e, b) - max(s, a))
        return t

    def gaps(self, a: float, b: float) -> list:
        """The idle [start, end] intervals inside [a, b]."""
        out, t = [], a
        for s, e in self.spans[self._first(a):]:
            if s >= b:
                break
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < b:
            out.append((t, b))
        return out


def busy_ms(r, name: str):
    """Device-busy ms a unit inside the spans named `name`; None where no
    unit holds one."""
    us = units(r)
    if us is None:
        return None
    spans = [s for u in us for s in u.spans if s.name == name]
    if not spans:
        return None
    busy = Busy(r.trace.ops)
    us_sum = sum(busy.within(s.start_us, s.end_us) for s in spans)
    return us_sum / 1e3 / len(us)


def host_syncs(r):
    """Host syncs a unit, as the program counts them (`host_sync`: the
    warnings of CUDA's sync debug mode while the unit ran; it does not
    rest on the alignment)."""
    us = aligned(r)
    if us is None:
        return None
    return sum(u.counts.get("host_sync", 0) for u in us) / len(us)


def _sync_windows(u) -> list:
    """The merged extents of a unit's sync spans, each widened by EDGE_US
    on both sides, within the unit."""
    a, b = u.spans[0].start_us, u.spans[0].end_us
    return union([(None, max(a, x.start_us - EDGE_US),
                   min(b, x.end_us + EDGE_US)) for x in u.spans if x.sync])


def _idle(busy, a: float, b: float, windows=None) -> float:
    """Idle microseconds inside [a, b], or inside its overlap with
    `windows`."""
    if windows is None:
        return (b - a) - busy.within(a, b)
    return sum(_idle(busy, max(a, s), min(b, e)) for s, e in windows
               if min(b, e) > max(a, s))


def sync_idle_share(r):
    """Percent of the units' idle device time inside the extents of the
    sync spans (`_sync_windows`): from the drain the host waits for to its
    wake. The rest the host spends launching or computing."""
    us = units(r)
    if us is None:
        return None
    busy = Busy(r.trace.ops)
    idle = in_sync = 0.0
    for u in us:
        a, b = u.spans[0].start_us, u.spans[0].end_us
        idle += _idle(busy, a, b)
        in_sync += _idle(busy, a, b, _sync_windows(u))
    return 100.0 * in_sync / idle if idle > 0 else 0.0


def table(r) -> dict:
    """Busy, idle and sync-idle (idle inside `_sync_windows`) ms a unit of
    each stage (a span directly under the unit's own), summed by name, of
    the units' own span ("unit") and of the unit outside every stage ("in
    no stage"); the stages with those sum to the unit. Each span directly
    under a stage adds a row "<stage>/<span>", inside its stage's."""
    us = aligned(r)
    if us is None:
        return {}
    busy = Busy(r.trace.ops)
    rows = {}

    def add(name, *vals):
        row = rows.setdefault(name, [0.0, 0.0, 0.0])
        for k, v in enumerate(vals):
            row[k] += v / 1e3 / len(us)

    for u in us:
        top, win = u.spans[0], _sync_windows(u)
        vals = [busy.within(top.start_us, top.end_us),
                _idle(busy, top.start_us, top.end_us),
                _idle(busy, top.start_us, top.end_us, win)]
        add("unit", *vals)
        for s in u.spans[1:]:
            got = (busy.within(s.start_us, s.end_us),
                   _idle(busy, s.start_us, s.end_us),
                   _idle(busy, s.start_us, s.end_us, win))
            if s.parent == 0:
                add(s.name, *got)
                vals = [v - g for v, g in zip(vals, got)]
            elif u.spans[s.parent].parent == 0:
                add(u.spans[s.parent].name + "/" + s.name, *got)
        add("in no stage", *vals)
    return {k: {"busy_ms": v[0], "idle_ms": v[1], "sync_idle_ms": v[2]}
            for k, v in rows.items()}


def counts(r) -> dict:
    """Each counter's mean a unit over the device-traced units."""
    us = aligned(r) or []
    out = {}
    for u in us:
        for k, v in u.counts.items():
            out[k] = out.get(k, 0.0) + v / len(us)
    return out


def edges(r) -> dict:
    """The alignment's check: the device operations that cross a unit's
    edge by more than EDGE_US (the first few: name, unit, start less the
    unit's opening, end less its closing), the host-device copies inside a
    unit in no sync span and the sync spans after the first unit's that
    hold none (`align.misses`), and the device ms a unit between units (work
    outside the program's units, such as the serve loop's copy out)."""
    us = aligned(r)
    if us is None:
        return {}
    cross, outside = _crossing(r.trace.ops, us)
    return {"crossing_ops": len(cross),
            "stray_copies": misses(us, r.trace.ops)[0],
            "empty_sync_spans": misses(us, r.trace.ops)[1],
            "outside_units_ms": outside / 1e3 / len(us),
            "crossing": cross[:4]}


NEW = ("host_syncs", "sync_idle_share", "project_ms", "bin_ms", "gather_ms",
       "backward_ms.train", "update_ms.train", "targets_ms.train")


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one `with span(...)` off, and on (under a
    device-only profiler session with CUDA initialized) inside a unit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vegs_torch.utils import trace

    def loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("raster.bin"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = min(loop(n) for _ in range(5))
    on = []
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(3):
            with trace.span("video.frame"):
                on.append(loop(n // 10))
            torch.cuda.synchronize()
            trace.reset()
    return {"off_us": off, "on_us": min(on)}


def sync_cost_us(n: int = 2000) -> dict:
    """Host microseconds of one `.item()` on the card: plain, under a
    device-only profiler session, and there inside a unit, where CUDA's
    sync debug mode warns of it and `host_sync` counts it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vegs_torch.utils import trace

    x = torch.zeros((), device="cuda")

    def loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            x.item()
        return (time.perf_counter() - t0) / n * 1e6

    plain = min(loop(n) for _ in range(3))
    with profile(activities=[ProfilerActivity.CUDA]):
        profiled = min(loop(n) for _ in range(3))
        counted = []
        for _ in range(3):
            with trace.span("video.frame"):
                counted.append(loop(n))
            trace.reset()
    return {"plain_us": plain, "profiled_us": profiled,
            "counted_us": min(counted)}


def main(argv=None) -> int:
    import argparse
    from types import SimpleNamespace

    import torch

    from . import loops, profile, run
    from vegs_torch.utils import trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = run.load_cell(args.workload)
    dev = torch.device("cuda")
    walls = {"on": [], "off": [], "no_watch": []}
    record = profile.record

    def null_span(name, sync=False):
        return trace._NULL

    class NoWatch:
        def close(self):
            pass

    def turns(fn, dev, host=False):
        """The device-traced session, then the same units nine more times
        in turns: with `span` patched to the null context ("off"), as they
        are ("on"), and with the sync count's watch patched out
        ("no_watch")."""
        tr = record(fn, dev, host)
        if not host and not walls["on"]:
            walls["on"].append(tr.wall_s)
            for state in ("off", "on", "no_watch") * 3:
                if state == "off":
                    trace.span = null_span
                if state == "no_watch":
                    trace._Watch = NoWatch
                try:
                    walls[state].append(record(fn, dev).wall_s)
                finally:
                    trace.span, trace._Watch = span, watch
        return tr

    span, watch = trace.span, trace._Watch
    profile.record = turns
    try:
        res = loops.KINDS[spec["traffic"]["kind"]](
            spec["config"], spec["traffic"], args.seed, args.seconds, True,
            dev, run.T_START)
    finally:
        profile.record = record
    r = SimpleNamespace(trace=res["trace"], units=res["trace_units"])
    names = [m["name"] for m in spec["per_layer"]
             if m["name"].split(".")[0] in {n.split(".")[0] for n in NEW}]
    per_unit = {k: [1e3 * w / r.units for w in v] for k, v in walls.items()}
    out = {"workload": args.workload, "seed": args.seed,
           "card": run.card_line(),
           "metrics": {n: run.metric_reader(n)(r) for n in names},
           "counts": counts(r), "table": table(r), "edges": edges(r),
           "spans_per_unit": sum(len(u.spans) for u in aligned(r)) / r.units,
           "host_ms_per_unit": per_unit,
           "on_cost_ms": (statistics.median(per_unit["on"])
                          - statistics.median(per_unit["off"])),
           "watch_cost_ms": (statistics.median(per_unit["on"])
                             - statistics.median(per_unit["no_watch"])),
           "span": span_cost_us(), "sync": sync_cost_us()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
