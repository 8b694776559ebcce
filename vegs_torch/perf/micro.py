"""The glue micro-probes at the bench shape: port of perf/micro_r02.py,
perf/micro2_r02.py, perf/r03_micro.py and perf/r03_micro2.py.

K = 2^21 instance rows, N = 500,000 Gaussians, C = 24 payload columns,
each group's arrays drawn from numpy seed 0 in its script's order (a
probe that draws at set-up time, as micro_r02's scatter and int32 gather
do, draws from the group's generator when it is set up, so a group run
whole draws what the script draws). Four groups:

- `micro_r02` (micro_r02.py:229-244, the 14 probes of its `ALL`): row
  gathers of f32, bf16 and int32 rows by a permutation and from an
  N-row table, the gather backward as the JAX package once ran it (sort,
  permutation gather, blocked cumsum, boundary gathers) and with the ids
  presorted, `segment_sum` on sorted ids, a two-operand sort, a unique
  sorted scatter;
- `micro2_r02` (micro2_r02.py:65-129): the transposes (the sliced use,
  and materialised), a copy as the control, and the binning internals
  (the slot -> Gaussian searchsorted, the record gather, the key sort,
  the relayout gather, `bin_gaussians` whole);
- `r03_micro` (r03_micro.py:58-141): three transposes with their
  consumer, two sorted unique scatter-adds, the [K, 8] int32 blocked
  cumsum, the cotangent reorder gather, 2- and 3-operand sorts, the
  searchsorted slot map and the row-8 gather. The unsorted unique scatter
  at :64-73 is commented out there ("pathological: hangs/serializes" on
  the TPU) and is not ported;
- `r03_micro2` (r03_micro2.py:58-103): the two searchsorted calls of the
  binning and the gather's forward, 2- and 3-operand sorts, the
  boundary-delta slot map, the bf16 row-16 gather.

Each probe is a set-up function of the group's data that returns a
callable; the callable computes the line's arrays and returns them, so
the tests hold them against the JAX script's. The JAX counterparts:
`jax.lax.sort` over several operands is `torch.sort` of the key and a
gather of the carried operands by its permutation
(`binning_probes.sort_carry`); `jnp.searchsorted(method="sort")` is
`torch.searchsorted`; `jax.ops.segment_sum` on sorted ids is
`torch.segment_reduce` with the segments' lengths; a unique
`.at[].set` / `.at[].add` into zeros is `index_copy_` / `index_add_`;
bf16 rows the JAX code gathers as int32 pairs are `.view(torch.int32)`.
A transpose XLA fuses into its consumer is a view here: its line times
the view with its consumer, and the materialised transpose
(`.t().contiguous()`) is a line of its own.

The JAX scripts difference an in-jit `fori_loop` of 1 and 1 + 8 calls and
thread a data dependency through each call (`dep`, `dep_i`, `depi`;
micro_r02.py:26-43, :59-63) to cancel a remote TPU's dispatch latency.
The port times each callable with `timing.measure` (CUDA events for the
stream, torch.profiler for the card's own time) and needs neither.

Run on the card:  python -m vegs_torch.perf.micro [name ...]
(a name is a group, a probe, or one of micro2_r02's sections
"transpose", "copy", "binning"; one JSON line a probe; a failing probe
raises and the run exits non-zero)
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import resolve_device
from ..ops import binning
from .binning_probes import blocked_cumsum, sort_carry
from .timing import device_line, measure

K = 1 << 21          # instance rows (the bench at k_cap 2M)
N = 500_000          # Gaussians
C = 24               # payload columns
BLOCK = 512          # the blocked cumsum's block
BIN_HW = (376, 1408)  # micro2_r02.py:84's tile grid


class Data(dict):
    """A group's arrays by name, on one device, and the numpy generator
    that drew them (set-up functions may draw more)."""

    def __init__(self, rng, device, k, n, **arrays):
        super().__init__()
        self.rng, self.device, self.k, self.n = rng, device, k, n
        self.put(**arrays)

    def put(self, **arrays):
        for name, x in arrays.items():
            self[name] = torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device)
        return self

    def put_bf16(self, **arrays):
        """float32 numpy arrays stored as bf16 (round to nearest even, as
        JAX's astype)."""
        for name, x in arrays.items():
            self[name] = torch.from_numpy(x).to(torch.bfloat16).to(
                self.device)
        return self

    def long(self, name):
        """An index array as int64 (the indices torch's gathers take),
        made once."""
        key = name + "_long"
        if key not in self:
            self[key] = self[name].long()
        return self[key]


def gather3x8(t, i):
    """`ga` of micro_r02.py:145 (`_gather3x8` of the JAX package's
    rasterize.py, since removed): t's rows i, gathered as three row-8
    pieces of its [*, 24] columns and concatenated."""
    return torch.cat([t[:, j * 8:(j + 1) * 8][i] for j in range(3)], dim=1)


def _segment_diff(cum, ends, starts):
    # the boundary gathers of the inclusive cumsum with a zero row in front
    return gather3x8(cum, ends) - gather3x8(cum, starts)


def _with_zero_row(cum):
    return torch.cat([cum.new_zeros((1, cum.shape[1])), cum])


# -- micro_r02 ----------------------------------------------------------------


def r02_data(device, k: int = K, n: int = N, c: int = C,
             seed: int = 0) -> Data:
    """micro_r02.py:48-54's module-level arrays, in its order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(k).astype(np.int32)
    gidx = np.sort(rng.integers(0, n, k)).astype(np.int32)
    gidx_rand = rng.integers(0, n, k).astype(np.int32)
    rows_k = rng.standard_normal((k, c), dtype=np.float32)
    rows_n = rng.standard_normal((n, c), dtype=np.float32)
    return Data(rng, device, k, n, perm=perm, gidx=gidx, gidx_rand=gidx_rand,
                rows_k=rows_k, rows_n=rows_n)


def g_row8x3_2m(d):
    rows, idx = d["rows_k"], d.long("perm")
    return lambda: gather3x8(rows, idx)


def g_row24_2m(d):
    rows, idx = d["rows_k"], d.long("perm")
    return lambda: rows[idx]


def g_row16_bf16_2m(d):
    rows, idx = d["rows_k"][:, :16].to(torch.bfloat16), d.long("perm")
    return lambda: rows[idx]


def g_row8_bf16x2_2m(d):
    rows, idx = d["rows_k"][:, :16].to(torch.bfloat16), d.long("perm")
    return lambda: torch.cat([rows[:, :8][idx], rows[:, 8:][idx]], dim=1)


def g_from_small_table(d):
    rows, idx = d["rows_n"], d.long("gidx_rand")
    return lambda: gather3x8(rows, idx)


def g_from_small_table_sorted_idx(d):
    rows, idx = d["rows_n"], d.long("gidx")
    return lambda: gather3x8(rows, idx)


def g_take_axis0(d):
    rows, idx = d["rows_k"], d.long("perm")
    return lambda: torch.index_select(rows, 0, idx)  # jnp.take(axis=0)


def r_current_segment_reduce(d):
    """micro_r02.py:124: the gather backward as the JAX package ran it
    then: sort the ids carrying the row order, gather the rows into that
    order, blocked cumsum, each segment's ends by a searchsorted, the
    boundary gathers' difference."""
    g, gidx, n = d["rows_k"], d["gidx_rand"], d.n
    order = torch.arange(d.k, dtype=torch.int32, device=d.device)
    segs = torch.arange(n, dtype=torch.int32, device=d.device)

    def fn():
        gidx_s, order_s = sort_carry(gidx, order)
        cum = _with_zero_row(blocked_cumsum(gather3x8(g, order_s.long())))
        ends = torch.searchsorted(gidx_s, segs, right=True)  # method="sort"
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        return _segment_diff(cum, ends, starts)
    return fn


def r_presorted_segment_reduce(d):
    """micro_r02.py:153: the ids presorted, their ends found once: the
    blocked cumsum and the boundary gathers only."""
    g = d["rows_k"]
    ends = torch.searchsorted(
        d["gidx"], torch.arange(d.n, dtype=torch.int32, device=d.device),
        right=True)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])

    def fn():
        return _segment_diff(_with_zero_row(blocked_cumsum(g)), ends, starts)
    return fn


def r_jax_segment_sum_sorted(d):
    """`jax.ops.segment_sum(g, gidx, N, indices_are_sorted=True)`:
    `torch.segment_reduce` with each id's run length, counted once from
    the sorted ids (they do not change between calls)."""
    g = d["rows_k"]
    lengths = torch.bincount(d.long("gidx"), minlength=d.n)
    return lambda: torch.segment_reduce(g, "sum", lengths=lengths, axis=0)


def s_sort_pairs_2m(d):
    keys, vals = d["gidx_rand"], d["perm"]
    return lambda: sort_carry(keys, vals)


def sc_unique_scatter(d):
    """N rows set at N sorted unique positions of a [K, C] zero table
    (`.at[pos].set(unique_indices=True)`)."""
    pos = np.sort(d.rng.choice(d.k, d.n, replace=False)).astype(np.int32)
    d.put(sc_pos=pos)
    rows, idx = d["rows_n"], d.long("sc_pos")

    def fn():
        z = rows.new_zeros((d.k, rows.shape[1]))
        return z.index_copy_(0, idx, rows)
    return fn


def g_row4_int32_2m(d):
    rows = d.rng.integers(0, 1 << 20, (d.k, 4)).astype(np.int32)
    d.put(rows4=rows)
    rows, idx = d["rows4"], d.long("perm")
    return lambda: rows[idx]


def g_mixed_f8_bf16_2m(d):
    rf = d["rows_k"][:, :8].contiguous()
    rb = d["rows_k"][:, 8:].to(torch.bfloat16)
    idx = d.long("perm")
    return lambda: (rf[idx], rb[idx])


R02 = {
    "gather_row8x3_f32_2M_perm": g_row8x3_2m,
    "gather_row24_f32_2M_perm": g_row24_2m,
    "gather_row16_bf16_2M_perm": g_row16_bf16_2m,
    "gather_row8x2_bf16_2M_perm": g_row8_bf16x2_2m,
    "gather_row8x3_f32_2M_from_500k": g_from_small_table,
    "gather_row8x3_f32_2M_from_500k_sortedidx": g_from_small_table_sorted_idx,
    "take_axis0_row24_2M": g_take_axis0,
    "segment_reduce_current_full": r_current_segment_reduce,
    "segment_reduce_presorted": r_presorted_segment_reduce,
    "jax_segment_sum_sorted": r_jax_segment_sum_sorted,
    "sort_int32_pairs_2M": s_sort_pairs_2m,
    "scatter_unique_sorted_500k_rows": sc_unique_scatter,
    "gather_row4_int32_2M": g_row4_int32_2m,
    "gather_mixed_f32x8+bf16x16_2M": g_mixed_f8_bf16_2m,
}


# -- micro2_r02 ---------------------------------------------------------------


def r02b_data(device, k: int = K, n: int = N, seed: int = 0) -> Data:
    """micro2_r02.py:20-26's module-level arrays, in its order."""
    rng = np.random.default_rng(seed)
    a8 = rng.standard_normal((k, 8), dtype=np.float32)
    a16 = rng.standard_normal((k, 16), dtype=np.float32)
    cum = np.cumsum(rng.integers(0, 8, n).astype(np.int32)).astype(np.int32)
    gidx_rand = rng.integers(0, n, k).astype(np.int32)
    out = Data(rng, device, k, n, a8=a8, cum=cum, gidx_rand=gidx_rand)
    out.put_bf16(a16=a16)
    # the binning section's draws (micro2_r02.py:92-127), in its order
    out.put(rec=rng.integers(0, 1 << 12, (n, 8)).astype(np.int32),
            key=rng.integers(0, 1 << 30, k).astype(np.int32),
            packed=rng.integers(0, 1 << 20, (k, 2)).astype(np.int32),
            src=rng.permutation(k).astype(np.int32))
    out.put(m2d=np.stack([rng.uniform(0, BIN_HW[1], n),
                          rng.uniform(0, BIN_HW[0], n)], 1).astype(np.float32),
            dpt=rng.uniform(2, 60, n).astype(np.float32),
            rad=rng.integers(1, 9, n).astype(np.int32))
    return out


def tr_sliced(d):
    """The transposes as micro2_r02.py:65 uses them: views, consumed by
    their first 128 columns (what XLA fuses the transpose into). The view
    costs nothing; the line times the consumer's read."""
    a8, a16 = d["a8"], d["a16"]
    return lambda: (a8.t()[:, :128].contiguous(), a16.t()[:, :128].float())


def tr_materialized(d):
    """micro2_r02.py:74: both transposes materialised
    (`.t().contiguous()`)."""
    a8, a16 = d["a8"], d["a16"]
    return lambda: (a8.t().contiguous(), a16.t().contiguous())


def copy_control(d):
    a8 = d["a8"]
    return lambda: a8 + 1.0


def bin_searchsorted(d):
    """binning's slot -> Gaussian map, searchsorted of K slots in the
    N-entry cumsum (`method="sort"`)."""
    cum = d["cum"]
    slot = torch.arange(d.k, dtype=torch.int32, device=d.device)
    return lambda: torch.searchsorted(cum, slot, right=True)


def bin_rec_gather(d):
    rec, idx = d["rec"], d.long("gidx_rand")
    return lambda: rec[idx]


def bin_sort_pairs(d):
    key, gidx = d["key"], d["gidx_rand"]
    return lambda: sort_carry(key, gidx)


def bin_relayout(d):
    packed, src = d["packed"], d.long("src")
    return lambda: packed[src]


def bin_full(d):
    """`bin_gaussians` whole on uniform splats (radius 1-8 px) over the
    376x1408 grid at capacity K; returns its Gaussian index."""
    grid = binning.TileGrid.for_image(*BIN_HW)
    m2d, dpt, rad = d["m2d"], d["dpt"], d["rad"]
    return lambda: binning.bin_gaussians(m2d, dpt, rad, grid, d.k).gidx


R02B = {
    "transpose [2M,8]f32+[2M,16]bf16 (sliced use)": tr_sliced,
    "transpose materialized (asarray)": tr_materialized,
    "copy [2M,8] f32 (control)": copy_control,
    "binning: searchsorted slots->cum (sort)": bin_searchsorted,
    "binning: rec row-8 int32 gather [2M]": bin_rec_gather,
    "binning: lax.sort pairs [2M]": bin_sort_pairs,
    "binning: relayout row-2 int32 gather [2M]": bin_relayout,
    "binning: full bin_gaussians": bin_full,
}
# micro2_r02.py's command-line sections
R02B_SECTIONS = {"transpose": list(R02B)[:2], "copy": list(R02B)[2:3],
                 "binning": list(R02B)[3:]}


# -- r03_micro ----------------------------------------------------------------


def r03_data(device, k: int = K, n: int = N, seed: int = 0) -> Data:
    """r03_micro.py:59-64's arrays, in its order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(k).astype(np.int32)
    vals = rng.integers(0, k, k).astype(np.int32)
    xf = rng.normal(size=(k, 8)).astype(np.float32)
    xa = rng.normal(size=(k, 16)).astype(np.float32)
    cf = rng.normal(size=(8, k)).astype(np.float32)
    ca = rng.normal(size=(16, k)).astype(np.float32)
    out = Data(rng, device, k, n, perm=perm, vals=vals, xf=xf, cf=cf)
    out.put_bf16(xa=xa, ca=ca)
    out.put(pos=np.sort(rng.choice(k, n, replace=False)).astype(np.int32),
            deltas8=rng.normal(size=(n, 8)).astype(np.float32))
    out.put(xi=rng.integers(0, 3, (k, 8)).astype(np.int32))
    out.put(cum=np.sort(rng.integers(0, k, n)).astype(np.int32))
    out.put(tbl=rng.normal(size=(n, 8)).astype(np.float32),
            gidx=rng.integers(0, n, k).astype(np.int32))
    return out


def t_kc_to_ck(d):
    xf, cf = d["xf"], d["cf"]
    return lambda: xf.t() * cf      # the view and its consumer


def t_ck_to_kc(d):
    xf, cf = d["xf"], d["cf"]
    return lambda: cf.t() * xf


def t_ck_to_kc_bf16(d):
    # r03_micro.py:71 casts to f32 and back around its dependency: an
    # identity, left out
    xa, ca = d["xa"], d["ca"]
    return lambda: (ca.t() * xa).float()


def sc_add8(d):
    """The N boundary deltas added at N sorted unique positions of a
    [K, 8] zero table (`.at[pos].add(unique_indices=True)`)."""
    pos, deltas = d.long("pos"), d["deltas8"]
    return lambda: deltas.new_zeros((d.k, 8)).index_add_(0, pos, deltas)


def sc_add1(d):
    pos, deltas = d.long("pos"), d["deltas8"][:, 0].contiguous()
    return lambda: deltas.new_zeros((d.k,)).index_add_(0, pos, deltas)


def cumsum_i32(d):
    xi = d["xi"]
    return lambda: blocked_cumsum(xi, BLOCK)


def reorder_gather(d):
    f, b, perm = d["xf"], d["xa"], d.long("perm")
    return lambda: (f[perm], b[perm])


def sort2(d):
    keys, perm = d["vals"], d["perm"]
    return lambda: sort_carry(keys, perm)


def sort3(d):
    keys = d["vals"]
    both = torch.stack([d["perm"], d["perm"]], dim=1)

    def fn():
        ks, carried = sort_carry(keys, both)
        return (ks, *carried.unbind(1))
    return fn


def ss_slots(d):
    cum = d["cum"]
    slot = torch.arange(d.k, dtype=torch.int32, device=d.device)
    return lambda: torch.searchsorted(cum, slot, right=True)


def row8_gather(d):
    tbl, gidx = d["tbl"], d.long("gidx")
    return lambda: tbl[gidx]


R03 = {
    "transpose [K,8]f32 -> [8,K]": t_kc_to_ck,
    "transpose [8,K]f32 -> [K,8]": t_ck_to_kc,
    "transpose [16,K]bf16 -> [K,16]": t_ck_to_kc_bf16,
    "sorted unique scatter-add [N,8] -> [K,8]": sc_add8,
    "sorted unique scatter-add [N] -> [K]": sc_add1,
    "blocked cumsum [K,8] int32": cumsum_i32,
    "reorder gather rows8 f32 + rows16 bf16 [K]": reorder_gather,
    "lax.sort 2-operand [K]": sort2,
    "lax.sort 3-operand [K]": sort3,
    "searchsorted 'sort' N-table K-queries": ss_slots,
    "row8 gather K rows from [N,8]": row8_gather,
}


# -- r03_micro2 ---------------------------------------------------------------


def r03b_data(device, k: int = K, n: int = N, seed: int = 0) -> Data:
    """r03_micro2.py:59-64's arrays, in its order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(k).astype(np.int32)
    vals = rng.integers(0, k, k).astype(np.int32)
    cum_n = np.sort(rng.integers(0, k, n)).astype(np.int32)
    gidx_k = np.sort(rng.integers(0, n, k)).astype(np.int32)
    out = Data(rng, device, k, n, perm=perm, vals=vals, cum_n=cum_n,
               gidx_k=gidx_k)
    out.put(pos_n=np.sort(rng.choice(k, n, replace=False)).astype(np.int32),
            delta_n=rng.integers(0, 3, n).astype(np.int32))
    out.put_bf16(tbl16=rng.normal(size=(n, 16)).astype(np.float32))
    out.put(gidx=rng.integers(0, n, k).astype(np.int32))
    return out


def ss_cum_slots(d):
    cum = d["cum_n"]
    slot = torch.arange(d.k, dtype=torch.int32, device=d.device)
    return lambda: torch.searchsorted(cum, slot, right=True)


def ss_gidx_ends(d):
    """The gather forward's ends: searchsorted of the N Gaussians in the
    sorted [K] Gaussian index."""
    g = d["gidx_k"]
    segs = torch.arange(d.n, dtype=torch.int32, device=d.device)
    return lambda: torch.searchsorted(g, segs, right=True)


def sort2b(d):
    keys, perm = d["vals"], d["perm"]
    return lambda: sort_carry(keys, perm)


def sort3b(d):
    keys = d["vals"]
    slot = torch.arange(d.k, dtype=torch.int32, device=d.device)
    both = torch.stack([d["perm"], slot], dim=1)

    def fn():
        ks, carried = sort_carry(keys, both)
        return (ks, *carried.unbind(1))
    return fn


def boundary_delta(d):
    """The slot -> Gaussian map by boundary deltas: the N deltas added at
    their sorted unique positions of a [K] zero row, one blocked int32
    cumsum."""
    pos, delta = d.long("pos_n"), d["delta_n"]

    def fn():
        z = delta.new_zeros((d.k,)).index_add_(0, pos, delta)
        return blocked_cumsum(z, BLOCK)
    return fn


def bf16_row16_gather(d):
    tbl, gidx = d["tbl16"], d.long("gidx")
    return lambda: tbl[gidx]


R03B = {
    "searchsorted(cum[N], slot[K]) 'sort'": ss_cum_slots,
    "searchsorted(gidx_s[K], arange[N]) 'sort'": ss_gidx_ends,
    "lax.sort 2-operand [K]": sort2b,
    "lax.sort 3-operand [K]": sort3b,
    "boundary-delta scatter[N]+cumsum[K]": boundary_delta,
    "bf16 row16 gather K rows from [N,16]": bf16_row16_gather,
}


# -- running ------------------------------------------------------------------

GROUPS = {  # group: (its data, its probes in the script's order, K, N)
    "micro_r02": (r02_data, R02, K, N),
    "micro2_r02": (r02b_data, R02B, K, N),
    "r03_micro": (r03_data, R03, K, N),
    "r03_micro2": (r03b_data, R03B, K, N),
}


def select(groups: dict, names=None) -> dict:
    """{group: [probe names]} of `groups` for `names` (groups or probes;
    None or empty: everything), in the scripts' order."""
    want = set(names or ())
    known = set(groups) | {p for _, probes, _, _ in groups.values()
                           for p in probes}
    if want - known:
        raise ValueError(f"no such probe or group: {sorted(want - known)}")
    out = {}
    for group, (_, probes, _, _) in groups.items():
        picked = [p for p in probes if not want or group in want or p in want]
        if picked:
            out[group] = picked
    return out


def run_groups(groups: dict, names=None, device=None, iters: int = 20,
               warmup: int = 3, emit=None, sizes=None) -> dict:
    """Time the probes of `groups` that `names` selects (`select`) on
    `device` (the card unless device="cpu"), each group's data made at its
    (K, N) or at `sizes[group]`; one dict a probe to `emit` (default: a
    JSON line). Returns {"lines": {group: {probe: line}}, "card": ...}."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    res = {}
    for group, picked in select(groups, names).items():
        make, probes, k, n = groups[group]
        d = make(dev, *(sizes or {}).get(group, (k, n)))
        lines = {}
        with torch.no_grad():
            for name in picked:
                line = {"probe": group, "line": name,
                        **measure(probes[name](d), dev, iters, warmup)}
                emit(**line, card=card)
                lines[name] = line
        res[group] = lines
        del d
    return {"lines": res, "card": card}


def run(names=None, **kw) -> dict:
    """`run_groups` of this module's groups; a name may also be one of
    micro2_r02's sections ("transpose", "copy", "binning")."""
    names = [p for x in names or () for p in R02B_SECTIONS.get(x, [x])]
    return run_groups(GROUPS, names, **kw)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
