"""The payload gather's backward, piece by piece, at the bench shapes: port
of perf/r04_gebwd.py, perf/r05_gebwd2.py, perf/r05_segreduce.py and
perf/r05_segreduce2.py.

Each group's arrays are drawn from numpy seed 0 in its script's order.

- `r04_gebwd` (K = 2^21 rows, N = 500,000 Gaussians; r04_gebwd.py:54-99):
  the cotangent reorder gathers (f32 rows, bf16 rows as int32 pairs, both
  cast into one bf16 table), the [K, 24] blocked cumsum, the boundary
  gathers of the cumsum (f32 row-24, and bf16 row-12 as int32 sextets), the
  row-24 reorder gather, and a permutation inverted by a two-operand sort
  and by a unique scatter;
- `r05_gebwd2` (K = 1,126,912, the bench's k_cap, and N = 500,001 with the
  dummy row; r05_gebwd2.py:68-162): the two row-8 gathers against one
  fused [K, 16] int32 row gather (packed, packed here, packed from the
  channel-major cotangents), the transposes around the blend kernels, and
  the cumsum-and-boundary segment path alone and with its gathers;
- `r05_segreduce` (the same shape; r05_segreduce.py:54-82): `seg_only`, a
  plain per-segment sum of the [K, 16] int32 packed rows unpacked to 8
  float32 and 16 bf16 columns, and `full_new`, the whole gather backward:
  kernel K3 as the main path runs it (`segreduce.gather_expand_bwd`) on
  the channel-major cotangents d_pf_t [8, K] f32, d_pa_t [16, K] bf16,
  `order` and the padded `ends`;
- `r05_segreduce2` (the same shape, 24 columns, NG = 500,224 segments with
  random sorted ends, the last 223 empty; r05_segreduce2.py:68-98):
  `seg_only`, K3 under the JAX package's contract
  (`segreduce.segment_reduce_cols` on [24, K] raw-order columns), and
  `full_new` as the script composes it: pack, the masked fused gather,
  `unpack_to_cm`, K3 in the JAX contract, the transposes out.

The JAX package no longer runs two of these as written: r04_gebwd.py:20
imports `_gather3x8`, which rasterize.py no longer defines, and
r05_segreduce.py:19 imports `segment_reduce_rows`, which segreduce.py never
defined. `_gather3x8` is `ga` of micro_r02.py:145 (`micro.gather3x8`);
`segment_reduce_rows` is the two counterparts above.

Each probe is a set-up function of the group's data returning a callable
that computes the line's arrays, as in `micro`. The JAX scripts' in-jit
loop differencing is replaced by `timing.measure`.

Run on the card:  python -m vegs_torch.perf.gebwd [name ...]
(a name is a group or a probe; one JSON line a probe)
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import segreduce
from .binning_probes import blocked_cumsum, sort_carry
from .micro import Data, gather3x8, run_groups
from .timing import device_line, measure

K4 = 1 << 21          # r04_gebwd.py:22
N4 = 500_000
K5 = 1_126_912        # r05_gebwd2.py:27, the bench's auto-sized k_cap
N5 = 500_001          # n + the dummy row
GB = 512              # the JAX contract's segments per output block
I32 = torch.int32


def ng_of(n1: int) -> int:
    """The segment count padded to the JAX contract's block of GB."""
    return -(-n1 // GB) * GB


def gather_rows_aux(table, idx):
    """Row gather of a [R, 16] bf16 (or f32) table (the counterpart of
    vegs_tpu/ops/rasterize.py:93 `_gather_rows_aux`): bf16 rows are read
    as [R, 8] int32 pairs, gathered, and read back as bf16."""
    if table.dtype == torch.bfloat16:
        return table.view(I32)[idx].view(torch.bfloat16)
    return table[idx]


def pack_rows(d_pf, d_pa):
    """[K, 8] f32 and [K, 16] bf16 rows -> [K, 16] int32: the f32 bits,
    then the bf16 pairs (r05_gebwd2.py:72-75)."""
    return torch.cat([d_pf.view(I32), d_pa.contiguous().view(I32)], dim=1)


def unpack_to_cm(g16):
    """[K, 16] int32 (8 f32 columns, 8 bf16 pairs) -> [24, K] f32
    channel-major, the aux columns back in their order
    (r05_segreduce2.py:52, rasterize.py:179): a bf16 widens to f32 as a
    16-bit left shift (the pair's first, low half) or a mask of the high
    half (its second)."""
    gt = g16.t()
    aux = gt[8:]
    lo = (aux << 16).view(torch.float32)
    hi = (aux & -65536).view(torch.float32)
    inter = torch.stack([lo, hi], dim=1).reshape(16, g16.shape[0])
    return torch.cat([gt[:8].view(torch.float32), inter])


def unpack_rows(g16):
    """[K, 16] int32 packed rows -> [K, 24] f32 row-major (`unpack_to_cm`
    transposed)."""
    return torch.cat([g16[:, :8].view(torch.float32),
                      g16[:, 8:].contiguous().view(torch.bfloat16).float()],
                     dim=1)


def segment_sum_rows(rows, starts, ends):
    """out[g] = the sum of rows[starts[g]:ends[g]] for [K, C] f32 rows and
    contiguous segments (starts[g] = ends[g - 1], starts[0] = 0), each
    segment's rows in order: `torch.segment_reduce` with the lengths."""
    total = int(ends[-1])
    return torch.segment_reduce(rows[:total], "sum",
                                lengths=(ends - starts).long(), axis=0)


def segment_path(g_f, g_a, ends):
    """The JAX package's former segment path (r05_gebwd2.py:117-130,
    rasterize.py:241-254): blocked inclusive cumsums of the f32 and aux
    halves, each segment's cumsum at ends - 1 (0 where ends is 0), each
    row less the one before."""
    cum_f = blocked_cumsum(g_f)
    cum_a = blocked_cumsum(g_a)
    e_idx = torch.clamp(ends - 1, min=0).long()
    nonempty = (ends > 0).float()[:, None]
    cf = cum_f[e_idx] * nonempty
    ca = torch.cat([cum_a[:, :8][e_idx], cum_a[:, 8:][e_idx]], dim=1)
    ca = ca * nonempty
    c = torch.cat([cf, ca], dim=1)
    return c - torch.cat([c.new_zeros((1, c.shape[1])), c[:-1]])


def masked_gather(p, order):
    """p's rows at `order`, zero where the row is dead (order >= len(p))."""
    dead = (order >= p.shape[0])[:, None]
    idx = torch.where(dead[:, 0], torch.zeros_like(order), order).long()
    return torch.where(dead, torch.zeros((), dtype=p.dtype, device=p.device),
                       p[idx])


# -- r04_gebwd ----------------------------------------------------------------


def r04_data(device, k: int = K4, n: int = N4, seed: int = 0) -> Data:
    """r04_gebwd.py:55-61's arrays, then :87-88's, in its order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(k + 8)[:k].astype(np.int32)
    d_pf = rng.normal(size=(k, 8)).astype(np.float32)
    d_pa = rng.normal(size=(k, 16)).astype(np.float32)
    ends = np.sort(rng.integers(0, k, n + 1).astype(np.int32))
    cum24 = rng.normal(size=(k + 1, 24)).astype(np.float32)
    g24 = rng.normal(size=(k, 24)).astype(np.float32)
    perm = rng.permutation(k).astype(np.int32)
    vals = rng.integers(0, k, k).astype(np.int32)
    return Data(rng, device, k, n, order=order, d_pf=d_pf, ends=ends,
                cum24=cum24, g24=g24, perm=perm, vals=vals).put_bf16(
                    d_pa=d_pa)


def _pad8(x):
    return F.pad(x, (0, 0, 0, 8))


def reorder_f32(d):
    pf, order = d["d_pf"], d.long("order")
    return lambda: _pad8(pf)[order]


def reorder_bf16_as_i32(d):
    pa, order = d["d_pa"], d.long("order")
    return lambda: gather_rows_aux(_pad8(pa), order)


def cumsum_k24(d):
    g24 = d["g24"]
    return lambda: blocked_cumsum(g24)


def boundary_3x8(d):
    cum, ends = d["cum24"], d.long("ends")
    return lambda: gather3x8(cum, ends)


def fused_bf16_16(d):
    """The f32 cotangents cast to bf16 beside the first 8 aux columns: one
    [K, 16] bf16 table, one row-8 int32 gather."""
    all16 = torch.cat([d["d_pf"].to(torch.bfloat16), d["d_pa"][:, :8]], dim=1)
    order = d.long("order")
    return lambda: gather_rows_aux(_pad8(all16), order)


def boundary_bf16_12(d):
    """The boundary gather from a bf16 cumsum: rows of 12 bf16 read as 6
    int32, gathered, read back and widened."""
    cum12 = d["cum24"][:, :12].to(torch.bfloat16)
    ends = d.long("ends")
    return lambda: cum12.view(I32)[ends].view(torch.bfloat16).float()


def reorder_24(d):
    g24, order = d["g24"], d.long("order")
    return lambda: gather3x8(_pad8(g24), order)


def invert_by_sort(d):
    perm, vals = d["perm"], d["vals"]
    return lambda: sort_carry(perm, vals)[1]


def invert_by_scatter(d):
    perm, vals = d.long("perm"), d["vals"]
    return lambda: vals.new_zeros((d.k,)).index_copy_(0, perm, vals)


R04 = {
    "reorder gather f32 row-8 [K]": reorder_f32,
    "reorder gather bf16-as-int32 row-8 [K]": reorder_bf16_as_i32,
    "blocked cumsum [K,24] f32": cumsum_k24,
    "boundary gather3x8 [N] of [K+1,24]": boundary_3x8,
    "fused bf16 gather row-8-int32 (16 cols) [K]": fused_bf16_16,
    "boundary gather [N] rows-12-bf16 (as 6xint32)": boundary_bf16_12,
    "reorder gather f32 row-24 [K] (3x8 pieces)": reorder_24,
    "perm-invert via 2-op sort [K]": invert_by_sort,
    "perm-invert via unique scatter [K]": invert_by_scatter,
}


# -- r05_gebwd2 ---------------------------------------------------------------


def r05b_data(device, k: int = K5, n: int = N5, seed: int = 0) -> Data:
    """r05_gebwd2.py:68-77's arrays, in its order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(k).astype(np.int32)
    d_pf = rng.normal(size=(k, 8)).astype(np.float32)
    d_pa = rng.normal(size=(k, 16)).astype(np.float32)
    ends = np.sort(rng.integers(0, k, n).astype(np.int32))
    out = Data(rng, device, k, n, order=order, d_pf=d_pf,
               ends=ends).put_bf16(d_pa=d_pa)
    out["d_pf_t"] = out["d_pf"].t().contiguous()
    out["d_pa_t"] = out["d_pa"].t().contiguous()
    out["packed"] = pack_rows(out["d_pf"], out["d_pa"])
    return out


def two_gathers(d):
    pf, pa, idx = d["d_pf"], d["d_pa"], d.long("order")
    return lambda: (pf[idx], gather_rows_aux(pa, idx))


def one_gather(d):
    p, idx = d["packed"], d.long("order")
    return lambda: p[idx]


def pack_and_gather(d):
    pf, pa, idx = d["d_pf"], d["d_pa"], d.long("order")
    return lambda: pack_rows(pf, pa)[idx]


def pack_t_and_gather(d):
    """The pack from the channel-major cotangents the blend backward
    emits: both transposes, then the pack and the fused gather."""
    pft, pat, idx = d["d_pf_t"], d["d_pa_t"], d.long("order")
    return lambda: pack_rows(pft.t(), pat.t())[idx]


def t_f32_cm_rm(d):
    pft, pf = d["d_pf_t"], d["d_pf"]
    return lambda: pft.t() * pf      # the view and its consumer


def t_bf16_cm_rm(d):
    pat, pa = d["d_pa_t"], d["d_pa"]
    return lambda: (pat.t() * pa).float()


def t_f32_rm_cm(d):
    pf, pft = d["d_pf"], d["d_pf_t"]
    return lambda: pf.t() * pft


def seg_path(d):
    pf, pa, ends = d["d_pf"], d["d_pa"], d["ends"]
    return lambda: segment_path(pf, pa.float(), ends)


def full_current(d):
    """The whole former backward: the masked reorder gathers, then the
    segment path."""
    pf, pa, order, ends = d["d_pf"], d["d_pa"], d["order"], d["ends"]

    def fn():
        g_f = masked_gather(pf, order)
        g_a = masked_gather(pa.view(I32), order).view(torch.bfloat16).float()
        return segment_path(g_f, g_a, ends)
    return fn


R05B = {
    "two gathers: f32 row-8 + bf16-as-int32 row-8": two_gathers,
    "ONE fused [K,16]-int32 row gather (64 B rows)": one_gather,
    "pack (bitcast+concat) + fused gather": pack_and_gather,
    "transpose [8,K]+[16,K] + pack + fused gather": pack_t_and_gather,
    "transpose [8,K] f32 -> [K,8]": t_f32_cm_rm,
    "transpose [16,K] bf16 -> [K,16]": t_bf16_cm_rm,
    "transpose [K,8] f32 -> [8,K] (fwd side)": t_f32_rm_cm,
    "XLA segment path (cumsum + boundary gather + diff)": seg_path,
    "FULL current _ge_bwd (gathers+mask+segment)": full_current,
}


# -- r05_segreduce and r05_segreduce2 -----------------------------------------


def _spans(rng, k, n1):
    """r05_segreduce2.py:72-76: n1 sorted random ends padded to NG with
    the last, and the starts they imply."""
    ends_r = np.sort(rng.integers(0, k, n1)).astype(np.int32)
    ends = np.concatenate([ends_r, np.full(ng_of(n1) - n1, ends_r[-1],
                                           np.int32)])
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    return ends, starts


def _cotangents_t(rng, k):
    d_pf_t = rng.normal(size=(8, k)).astype(np.float32)
    d_pa_t = rng.normal(size=(16, k)).astype(np.float32)
    return d_pf_t, d_pa_t


def r05s_data(device, k: int = K5, n: int = N5, seed: int = 0) -> Data:
    """r05_segreduce.py:54-62's arrays, in its order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(k).astype(np.int32)
    d_pf_t, d_pa_t = _cotangents_t(rng, k)
    ends, starts = _spans(rng, k, n)
    packed = rng.integers(-2**31, 2**31, (k, 16)).astype(np.int64).astype(
        np.int32)
    return Data(rng, device, k, n, order=order, d_pf_t=d_pf_t, ends=ends,
                starts=starts, packed=packed).put_bf16(d_pa_t=d_pa_t)


def r05s2_data(device, k: int = K5, n: int = N5, seed: int = 0) -> Data:
    """r05_segreduce2.py:68-76's arrays, in its order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(k).astype(np.int32)
    d_pf_t, d_pa_t = _cotangents_t(rng, k)
    ends, starts = _spans(rng, k, n)
    cols = rng.normal(size=(24, k)).astype(np.float32)
    return Data(rng, device, k, n, order=order, d_pf_t=d_pf_t, ends=ends,
                starts=starts, cols=cols).put_bf16(d_pa_t=d_pa_t)


def seg_only_rows(d):
    """`segment_reduce_rows` of the packed rows, as a plain per-segment sum
    of the unpacked rows: [NG, 24] f32."""
    p, s, e = d["packed"], d["starts"], d["ends"]
    return lambda: segment_sum_rows(unpack_rows(p), s, e)


def gather_bwd(d):
    """K3 as the main path runs it, the gather's whole backward, on the
    channel-major cotangents."""
    args = (d["d_pf_t"], d["d_pa_t"], d["order"], d["ends"])
    return lambda: segreduce.gather_expand_bwd(*args)


def seg_only_cols(d):
    """K3 under the JAX contract: [24, K] columns -> [24, NG]."""
    c, s, e = d["cols"], d["starts"], d["ends"]
    return lambda: segreduce.segment_reduce_cols(c, s, e)


def full_new_cols(d):
    """r05_segreduce2.py:84-98 as written: the channel-major cotangents
    packed row-major, the masked fused gather by `order`, `unpack_to_cm`,
    K3 in the JAX contract, the outputs sliced to n and transposed."""
    pft, pat, order = d["d_pf_t"], d["d_pa_t"], d["order"]
    s, e, n1 = d["starts"], d["ends"], d.n

    def fn():
        g = masked_gather(pack_rows(pft.t(), pat.t()), order)
        out = segreduce.segment_reduce_cols(unpack_to_cm(g), s, e)
        return out[:8, :n1].t(), out[8:, :n1].t().to(torch.bfloat16)
    return fn


SEG_ONLY_ROWS = "seg_only (segment_reduce_rows: unpack, per-segment sum)"
R05S = {SEG_ONLY_ROWS: seg_only_rows,
        "full_new (K3: gather_expand_bwd)": gather_bwd}
R05S2 = {"seg_only (K3: segment_reduce_cols)": seg_only_cols,
         "full_new (pack+gather+unpackT+K3)": full_new_cols}

GROUPS = {  # group: (its data, its probes, the default K and N)
    "r04_gebwd": (r04_data, R04, K4, N4),
    "r05_gebwd2": (r05b_data, R05B, K5, N5),
    "r05_segreduce": (r05s_data, R05S, K5, N5),
    "r05_segreduce2": (r05s2_data, R05S2, K5, N5),
}


def run(names=None, **kw) -> dict:
    """`micro.run_groups` of this module's groups (names: groups or
    probes)."""
    return run_groups(GROUPS, names, **kw)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
