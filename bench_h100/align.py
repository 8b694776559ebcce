"""The program's spans (`vegs_torch.utils.trace.recorded()`: device times
from two CUDA timing events a span, in microseconds from unit 0's
opening) placed on the clock of a profiler trace's device operations.

torch.profiler's device-only trace does not hold the timing events, and
the harness's `Trace` drops the `vegs::` ranges on the device's timeline
(`profile.record`), so the offset between the two clocks is fitted here
(`align`) from where the events must lie: between two operations of their
stream, and right behind the last queued one where the host is ahead.
"""

from __future__ import annotations

import numpy as np

# an operation crosses a span's edge only by more than STRADDLE_US; a timing
# event recorded behind queued work runs within SNAP_US after the last of it
# ends (microseconds)
STRADDLE_US = 2.0
SNAP_US = (-2.0, 6.0)
# the grid and histogram bins that find the offset's neighbourhood
# (`align`), how many of their points are narrowed, and how far a unit's
# offset may wander from the one before
GRID_US = 10.0
PEAKS = 64
DRIFT_US = 100.0
# the device operations that copy between host and device: each one inside
# a unit is a sync's, so it lies in a sync span (`_stray`)
COPIES = ("Memcpy HtoD", "Memcpy DtoH")
EDGE_US = 20.0


def _edges(unit) -> np.ndarray:
    return np.array([t for s in unit.spans for t in (s.start_us, s.end_us)])


def _scores(offsets, edges, starts, cum_end, ends):
    """(operations crossing an edge, edges right behind an operation's end,
    the summed distance of those edges from it) of each candidate offset;
    `starts` sorted, `cum_end` the running maximum of the ends in that
    order, `ends` sorted."""
    b = offsets[:, None] + edges[None, :]
    i = np.searchsorted(starts, b - STRADDLE_US) - 1
    cross = (i >= 0) & (cum_end[np.maximum(i, 0)] > b + STRADDLE_US)
    j = np.searchsorted(ends, b - SNAP_US[0], side="right") - 1
    dist = b - ends[np.maximum(j, 0)]
    snap = (j >= 0) & (dist <= SNAP_US[1])
    return cross.sum(1), snap.sum(1), np.where(snap, np.abs(dist), 0).sum(1)


def _fit(edges, prev, lo, hi, starts, cum_end, ends) -> float:
    """The clock offset in [lo, hi] at which the fewest operations cross an
    edge, then the most edges sit right behind an operation's end (a
    timing event recorded behind queued work runs as it drains), then those
    edges lie nearest to the ends, then the nearest to `prev`. Candidates
    put an edge at an operation's end."""
    j0 = np.searchsorted(ends, edges + lo)
    n = np.searchsorted(ends, edges + hi, side="right") - j0
    first = np.repeat(j0 - np.cumsum(n) + n, n)
    cand = ends[first + np.arange(n.sum())] - np.repeat(edges, n)
    cand = np.unique(np.append(cand, prev))
    cross, snap, dist = np.concatenate([
        np.stack(_scores(cand[k:k + 4096], edges, starts, cum_end, ends))
        for k in range(0, cand.size, 4096)], axis=1)
    key = np.lexsort((np.abs(cand - prev), dist, -snap, cross))
    return float(cand[key[0]])


def _peaks(edges, ends, lo) -> np.ndarray:
    """The centres of the PEAKS fullest GRID_US bins of a histogram of
    every operation's end less every edge, bins counted from `lo`."""
    counts = np.zeros(int((ends[-1] - edges.min() - lo) // GRID_US) + 1,
                      dtype=np.int64)
    for k in range(0, edges.size, 64):
        d = (ends[None, :] - edges[k:k + 64, None]).ravel()
        counts += np.bincount(((d - lo) // GRID_US).astype(np.int64),
                              minlength=counts.size)
    top = np.argpartition(-counts, min(PEAKS, counts.size - 1))[:PEAKS]
    return lo + (top + 0.5) * GRID_US


def _covered(offsets, opens, closes, bs, be) -> np.ndarray:
    """Busy microseconds inside the units' extents ([opens, closes] moved
    by each offset); `bs`, `be` the merged busy intervals."""
    before = np.concatenate([[0.0], np.cumsum(be - bs)])

    def upto(t):  # busy microseconds before t
        j = np.searchsorted(bs, t, side="right") - 1
        k = np.maximum(j, 0)
        inside = np.clip(t - bs[k], 0.0, be[k] - bs[k])
        return np.where(j >= 0, before[k] + inside, 0.0)

    o = offsets[:, None]
    return (upto(closes[None, :] + o) - upto(opens[None, :] + o)).sum(1)


def _misses(offsets, unit, copies) -> tuple:
    """With `unit` moved by each of `offsets`: the host-device copies
    ([M, 2] start, end) inside its extent but in none of its sync spans
    (each widened by EDGE_US), and the sync spans holding no copy."""
    o = offsets[:, None]
    s, e = copies[None, :, 0], copies[None, :, 1]
    top = unit.spans[0]
    inside = (s >= top.start_us + o - EDGE_US) & (e <= top.end_us + o + EDGE_US)
    held = np.zeros(inside.shape, bool)
    empty = np.zeros(offsets.shape, np.int64)
    for x in unit.spans:
        if x.sync:
            got = ((s >= x.start_us + o - EDGE_US)
                   & (e <= x.end_us + o + EDGE_US))
            held |= got
            empty += ~got.any(1)
    return (inside & ~held).sum(1), empty


def copies_of(ops) -> np.ndarray:
    """[M, 2] start, end of the host-device copies among `ops`."""
    return np.array([(s, e) for n, s, e in ops if n.startswith(COPIES)],
                    dtype=np.float64).reshape(-1, 2)


def misses(units: list, ops) -> tuple:
    """(the host-device copies that lie inside an aligned unit but in none
    of its sync spans, the sync spans of every unit but the first that hold
    no copy): none of either where the alignment holds, since each such
    copy inside a unit is a sync's and each sync span's sync is a copy
    (the trace may have lost unit 0's first operations)."""
    copies = copies_of(ops)
    got = [_misses(np.zeros(1), u, copies) for u in units]
    return (int(sum(m[0][0] for m in got)),
            int(sum(m[1][0] for m in got[1:])))


def _anchors(unit, copies) -> np.ndarray:
    """Offsets that put a copy at the opening of one of `unit`'s sync
    spans, on a GRID_US grid."""
    opens = np.array([x.start_us for x in unit.spans if x.sync])
    if not opens.size or not copies.size:
        return np.zeros(0)
    got = (copies[None, :, 0] - opens[:, None]).ravel()
    return np.unique(np.round(got / GRID_US) * GRID_US)


def align(units: list, ops) -> list:
    """`units` (device times from unit 0's opening) moved onto the clock
    of `ops`, the device operations a profiler traced over them, one
    offset a unit. A timing event runs between two operations of its
    stream, and right behind the last queued one where the host is ahead;
    a host-device copy inside a unit is a sync's. So at the true offset no
    operation crosses an edge, many edges sit just behind an operation's
    end, the units hold the traced device time and each sync span holds
    the copies. Unit 0's offset is the best of some candidates, each
    narrowed by `_fit`: the PEAKS offsets at which most edges sit behind
    an end (a histogram, `_peaks`), the PEAKS at which the units' extents
    cover the most busy time (a GRID_US grid over every offset that
    overlaps them with the trace), and the PEAKS that put a copy at one of
    unit 0's sync spans with the fewest misses (`_anchors`, `_misses`).
    The best has the fewest operations across unit 0's edges and misses,
    then the most edges behind an end, then those nearest to the ends.
    Each unit in turn then takes `_fit`'s offset within DRIFT_US of the one
    before. The trace's clock and the events' drift apart (by up to some
    hundred microseconds a second on an H100): with more than two units,
    the offsets' slope against the units' openings scales the events'
    times, and the units are placed again. The first operations traced
    need not be unit 0's, nor every operation a unit's (the serve loop
    copies each frame out between its units). Where no offset fits (the
    card's clocks disagree within a unit), the result is wrong: check it
    (`misses`, and the operations across the units' edges)."""
    if not ops or not units:
        return units
    order = sorted((s, e) for _, s, e in ops)
    starts = np.array([s for s, _ in order], dtype=np.float64)
    cum_end = np.maximum.accumulate(np.array([e for _, e in order],
                                             dtype=np.float64))
    ends = np.sort(np.array([e for _, e in order], dtype=np.float64))
    busy = []
    for s, e in order:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    bs, be = np.array(busy).T
    opens = np.array([u.spans[0].start_us for u in units])
    closes = np.array([u.spans[0].end_us for u in units])
    grid = np.arange(bs[0] - closes.max(), be[-1] - opens.min() + GRID_US,
                     GRID_US)
    cover = np.concatenate([_covered(grid[k:k + 4096], opens, closes, bs, be)
                            for k in range(0, grid.size, 4096)])
    every = np.concatenate([_edges(u) for u in units])
    copies = copies_of(ops)
    anchors = _anchors(units[0], copies)
    if anchors.size:
        miss = sum(_misses(anchors, units[0], copies))
        anchors = anchors[np.argsort(miss, kind="stable")[:PEAKS]]
    top = np.concatenate([grid[np.argsort(-cover, kind="stable")[:PEAKS]],
                          _peaks(every, ends, ends[0] - every.max()),
                          anchors])
    cand = np.array([_fit(every, c, c - GRID_US, c + GRID_US, starts,
                          cum_end, ends) for c in top])
    cross, snap, dist = _scores(cand, _edges(units[0]), starts, cum_end,
                                ends)
    bad = cross + sum(_misses(cand, units[0], copies))
    first = float(cand[np.lexsort((dist, -snap, bad))[0]])

    def place(rate, prev):
        """Each unit's offset in turn, its edges' times scaled by 1 + rate."""
        offs = []
        for u in units:
            prev = _fit(_edges(u) * (1 + rate), prev, prev - DRIFT_US,
                        prev + DRIFT_US, starts, cum_end, ends)
            offs.append(prev)
        return np.array(offs)

    offs = place(0.0, first)
    rate = 0.0
    if len(units) > 2:  # the clocks' drift within a unit too
        rate = float(np.polyfit(opens, offs, 1)[0])
        offs = place(rate, offs[0] - rate * opens[0])
    return [u._replace(spans=[
        s._replace(start_us=float(s.start_us * (1 + rate) + o),
                   end_us=float(s.end_us * (1 + rate) + o)) for s in u.spans])
        for u, o in zip(units, offs)]
