"""The binning and row-gather A/Bs at the bench shapes: port of
perf/r06_binning.py, perf/r08_binning2.py and perf/r11_recscan.py.

Each price is of the plain torch ops that compute what the JAX probe's
jitted function computes; `jax.lax.sort` over several operands becomes
`torch.sort` of the key and a gather of the others by its permutation
(one row gather of the stacked operands), and a `.at[].add(mode="drop")`
an `index_add_` of the in-range indices.

- `r06` (500k Gaussians, 16x16 tiles, k 1,126,912): the full bin and
  `bin_raw` alone; the slot -> Gaussian record map as JAX's binning builds
  it (`cur_map`: the run-start sort, a scatter of the run deltas, one
  int32 cumsum, the [k, 8] row gather) against the delta-encoded map
  (`delta_map`: +rec9[g] scattered at each run start and -rec9[g] at its
  end, one blocked int32 cumsum over [k, 9], column 8 the Gaussian index;
  int32 wraparound makes it exact for any bit pattern), the exactness
  check (`delta_exact`: record columns and index column equal to the bit),
  and the scatters and the cumsum alone.
- `r08` (500k, 16x32 tiles, the cull-compact path, k_cap and k_pad sized
  apart as r08:77-82 does): the full bin with and without its keys,
  `bin_raw`, the bin without the backward's maps (the port's `bin_raw`
  sorts one key and takes the raw slot from the permutation, so it has no
  rawslot operand to drop as r08's `want_rawslot=False` does), and
  `pad_relayout` with `want_keys=False` against `want_keys=True`.
- `r11` (n 2,233,571, k 4,867,584, seeded random int32 data as r11:52-58):
  the sort over n carrying 2 and 10 operands, the [k, 8] int32 scatter at
  sorted unique indices, the [k, 8] blocked cumsum, and today's row gather
  [n] -> [k]; and `rec_by_scan`, the scatter and cumsum that would replace
  the gather, checked against it equal to the bit (`scan_exact`).

Every line has `timing.measure`'s stream and device ms and the card.

Run on the card:  python -m vegs_torch.perf.binning_probes [r06 r08 r11]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import geometry, resolve_device
from ..ops import binning
from ..ops.binning import I32, _cumsum_i32
from ..ops.projection import project
from .refscale import build_scene
from .timing import device_line, measure

H, W = 376, 1408
N = 500_000
K_CAP = 1_126_912        # r06:31
R08_TILE = (16, 32)      # r08:32
R08_PROBE = 1 << 21      # r08:77
R11_N, R11_K = 2_233_571, 4_867_584  # r11:35-36
BLOCK = 512


def _bc(x):
    return x.to(torch.float32).contiguous().view(I32)


def projected(cam, arrays):
    """The scene's projection, detached: (means2d, depths, radii_xy,
    conics, opacities)."""
    means, quats, scales, opac, shs = arrays
    with torch.no_grad():
        p = project(means, geometry.cov6_from_scaling_rotation(scales, quats),
                    opac, shs, cam)
    return p.means2d, p.depths, p.radii_xy, p.conics, p.opacities


# -- r06 ---------------------------------------------------------------------


def r06_inputs(m2d, dpt, rxy, con, ops_, grid) -> dict:
    """r06:87-113: each Gaussian's packed [8] int32 record (and [9] with its
    index), its tile count's inclusive and exclusive cumsums, whether it is
    nonempty, and its run delta (index less the previous nonempty one's)."""
    n = m2d.shape[0]
    x0, y0, x1, y1 = binning.tile_rects(m2d, rxy, grid)
    active = rxy.min(dim=1).values > 0
    w_, h_ = x1 - x0 + 1, y1 - y0 + 1
    counts = torch.where(active, w_ * h_, torch.zeros_like(w_))
    cum = _cumsum_i32(counts)
    cum_excl = cum - counts
    nonempty = counts > 0
    dmax = 2.0 * torch.log(torch.clamp(255.0 * ops_.reshape(n),
                                       min=1.0 + 1e-6))
    dmax_q = torch.clamp(torch.ceil(dmax * (255.0 / 12.0)), max=255.0).to(I32)
    ts = grid.tile_shift
    rec = torch.stack(
        [x0 | (y0 << 12) | (dmax_q << 24), cum_excl,
         binning.depth_key(dpt, ts) | (w_ << ts),
         _bc(con[:, 0]), _bc(con[:, 1]), _bc(con[:, 2]),
         _bc(m2d[:, 0]), _bc(m2d[:, 1])], dim=1)
    gid = torch.arange(n, dtype=I32, device=m2d.device)
    rec9 = torch.cat([rec, gid[:, None]], dim=1)
    last = torch.cummax(torch.where(nonempty, gid, -torch.ones_like(gid)),
                        dim=0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    run_delta = torch.where(nonempty, gid - torch.clamp(prev, min=0),
                            torch.zeros_like(gid))
    return {"rec": rec, "rec9": rec9, "cum": cum, "cum_excl": cum_excl,
            "nonempty": nonempty, "run_delta": run_delta}


def _scatter_add(k: int, idx, vals):
    """zeros([k, ...]).at[idx].add(vals, mode="drop") for unique idx."""
    z = torch.zeros((k, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    keep = (idx >= 0) & (idx < k)
    z.index_add_(0, idx[keep].long(), vals[keep])
    return z


def blocked_cumsum(x, block: int = BLOCK):
    """r06:128 `cumsum9` / r11:82: an int32 cumsum over the rows of x ([k]
    or [k, c], k a multiple of `block`) as in-block cumsums plus the
    blocks' exclusive prefix, wrapping as int32 does."""
    k = x.shape[0]
    xb = x.reshape(k // block, block, *x.shape[1:])
    inner = torch.cumsum(xb, dim=1, dtype=x.dtype)
    tot = inner[:, -1]
    prefix = torch.cumsum(tot, dim=0, dtype=x.dtype) - tot
    return (inner + prefix[:, None]).reshape(x.shape)


def cur_map(k: int, cum_excl, run_delta, nonempty, rec):
    """r06:117: the slot -> Gaussian map as the JAX binning builds it: sort
    the run starts (carrying the run deltas), scatter the deltas, one int32
    cumsum (the Gaussian index per slot), then the [k, 8] row gather.
    Returns (rec[gidx] [k, 8], gidx [k])."""
    key = torch.where(nonempty, cum_excl, torch.full_like(cum_excl, k + 1))
    skey, perm = torch.sort(key, stable=True)
    gidx = _cumsum_i32(_scatter_add(k, skey, run_delta[perm]))
    return rec[gidx.long()], gidx


def delta_map(k: int, cum_excl, cum, nonempty, rec9):
    """r06:139: +rec9[g] at each nonempty Gaussian's run start, -rec9[g] at
    its run end (both unique-index scatters), one blocked int32 cumsum over
    [k, 9]: the slot's record in columns 0-7 and its Gaussian in 8."""
    far = torch.full_like(cum_excl, k + 1)
    zz = _scatter_add(k, torch.where(nonempty, cum_excl, far), rec9)
    zz -= _scatter_add(k, torch.where(nonempty, cum, far), rec9)
    return blocked_cumsum(zz)


def delta_exact(k: int, inp: dict) -> dict:
    """r06:150-169: the delta map's record columns and index column against
    the current map's on the first min(total, k) slots, to the bit."""
    new = delta_map(k, inp["cum_excl"], inp["cum"], inp["nonempty"],
                    inp["rec9"])
    old, gidx = cur_map(k, inp["cum_excl"], inp["run_delta"],
                        inp["nonempty"], inp["rec"])
    total = int(inp["cum"][-1])
    nr = min(total, k)
    return {"rec_cols": bool(torch.equal(new[:nr, :8], old[:nr])),
            "gidx_col": bool(torch.equal(new[:nr, 8], gidx[:nr])),
            "total": total, "nr": nr}


def r06(device=None, n: int = N, h: int = H, w: int = W, iters: int = 20,
        warmup: int = 3, emit=None) -> dict:
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    m2d, dpt, rxy, con, ops_ = projected(cam, arrays)
    grid = binning.TileGrid.for_image(h, w)
    k = K_CAP
    inp = r06_inputs(m2d, dpt, rxy, con, ops_, grid)
    ce, cu, ne = inp["cum_excl"], inp["cum"], inp["nonempty"]
    far = torch.full_like(ce, k + 1)

    def scatters():
        return (_scatter_add(k, torch.where(ne, ce, far), inp["rec9"])
                - _scatter_add(k, torch.where(ne, cu, far), inp["rec9"]))

    zz = scatters()
    exact = delta_exact(k, inp)
    emit(probe="r06", delta_exact=exact, card=card)
    fns = {
        "bin_gaussians full (want_keys=False)": lambda: binning.bin_gaussians(
            m2d, dpt, rxy, grid, k, conics=con, opacities=ops_,
            want_keys=False, want_grad_maps=True),
        "bin_raw only": lambda: binning.bin_raw(m2d, dpt, rxy, grid, k,
                                                conics=con, opacities=ops_),
        "current slot map: sort2 + scatter + cumsum + row-8 gather":
            lambda: cur_map(k, ce, inp["run_delta"], ne, inp["rec"]),
        "delta slot map: 2 row-9 scatters + [k, 9] cumsum":
            lambda: delta_map(k, ce, cu, ne, inp["rec9"]),
        "2 row-9 scatters only": scatters,
        "[k, 9] blocked cumsum only": lambda: blocked_cumsum(zz),
    }
    lines = {}
    with torch.no_grad():
        for name, fn in fns.items():
            line = {"probe": "r06", "stage": name,
                    **measure(fn, dev, iters, warmup)}
            line.pop("top", None)
            emit(**line, card=card)
            lines[name] = line
    return {"lines": lines, "delta_exact": exact, "card": card}


# -- r08 ---------------------------------------------------------------------


def r08_caps(m2d, dpt, rxy, con, ops_, grid, probe: int = R08_PROBE) -> dict:
    """r08:76-82: k_raw from `bin_raw`'s total at `probe` (+5% rounded up to
    512, at most `probe`), k_pad from `bin_gaussians`' padded need at
    k_raw (+5% rounded up to 512)."""
    with torch.no_grad():
        rb0 = binning.bin_raw(m2d, dpt, rxy, grid, probe, conics=con,
                              opacities=ops_)
        k_raw = min(probe, (int(rb0.total) * 21 // 20 + 511) // 512 * 512)
        b0 = binning.bin_gaussians(m2d, dpt, rxy, grid, k_raw, conics=con,
                                   opacities=ops_)
        k_pad = (int(b0.tile_starts[-1]) * 21 // 20 + 511) // 512 * 512
    return {"k_raw": k_raw, "k_pad": k_pad, "kept": int(b0.num_instances)}


def r08(device=None, n: int = N, h: int = H, w: int = W, iters: int = 20,
        warmup: int = 3, emit=None) -> dict:
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    cam, arrays = build_scene(n, h, w, dev)
    m2d, dpt, rxy, con, ops_ = projected(cam, arrays)
    grid = binning.TileGrid.for_image(h, w, *R08_TILE)
    caps = r08_caps(m2d, dpt, rxy, con, ops_, grid)
    emit(probe="r08", tile=f"{grid.tile_h}x{grid.tile_w}", **caps, card=card)
    k_raw, k_pad = caps["k_raw"], caps["k_pad"]
    geo = (m2d, dpt, rxy, grid, k_raw)
    cull = {"conics": con, "opacities": ops_}
    with torch.no_grad():
        rb = binning.bin_raw(*geo, **cull)
    relay = (rb.key_sorted, rb.gidx_sorted, rb.raw_starts, grid.num_tiles,
             k_pad)
    fns = {
        "bin_gaussians full (want_keys=False)": lambda: binning.bin_gaussians(
            *geo, **cull, want_keys=False, want_grad_maps=True, k_pad=k_pad),
        "bin_gaussians full (want_keys=True)": lambda: binning.bin_gaussians(
            *geo, **cull, want_keys=True, want_grad_maps=True, k_pad=k_pad),
        "bin_raw only": lambda: binning.bin_raw(*geo, **cull),
        "bin_gaussians without the backward's maps":
            lambda: binning.bin_gaussians(*geo, **cull, want_keys=False,
                                          want_grad_maps=False, k_pad=k_pad),
        "pad_relayout want_keys=False": lambda: binning.pad_relayout(
            *relay, dummy=n, want_keys=False),
        "pad_relayout want_keys=True": lambda: binning.pad_relayout(
            *relay, dummy=n, want_keys=True),
    }
    lines = {}
    with torch.no_grad():
        for name, fn in fns.items():
            line = {"probe": "r08", "stage": name,
                    **measure(fn, dev, iters, warmup)}
            line.pop("top", None)
            emit(**line, card=card)
            lines[name] = line
    return {"lines": lines, "caps": caps, "card": card}


# -- r11 ---------------------------------------------------------------------


def r11_data(n: int = R11_N, k: int = R11_K, seed: int = 0) -> dict:
    """r11:52-58's arrays, drawn from numpy in its order: keys, values, an
    [n, 8] int32 record table, n sorted unique run starts in [0, k), and a
    sorted [k] Gaussian index."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**30, n, dtype=np.int32)
    vals = np.arange(n, dtype=np.int32)
    rec = rng.integers(-2**30, 2**30, (n, 8), dtype=np.int32)
    starts = np.sort(rng.choice(k, n, replace=False)).astype(np.int32)
    gidx = np.sort(rng.integers(0, n, k)).astype(np.int32)
    return {"keys": keys, "vals": vals, "rec": rec, "starts": starts,
            "gidx": gidx}


def sort_carry(keys, carried):
    """`jax.lax.sort((keys, *carried), num_keys=1)` as `torch.sort` of the
    key and one gather of the carried columns (stacked [n, c]) by its
    permutation; `carried` [n] or [n, c]."""
    skeys, perm = torch.sort(keys, stable=True)
    return skeys, carried[perm]


def rec_by_scan(rec, starts, k: int):
    """The row gather rec[run(s)] for every slot s in [0, k), where run(s)
    is the last run whose start is <= s (slots before the first start read
    0), as r11's replacement computes it: each run's int32 row delta
    (wrapping) scattered at its start, one [k, 8] blocked cumsum."""
    delta = rec.clone()
    delta[1:] -= rec[:-1]
    return blocked_cumsum(_scatter_add(k, starts, delta))


def run_index(starts, k: int):
    """run(s) of `rec_by_scan` for every slot: the index of the last start
    <= s, clamped at 0 (the slots before the first start are masked by the
    caller)."""
    slot = torch.arange(k, dtype=starts.dtype, device=starts.device)
    return torch.clamp(torch.searchsorted(starts, slot, right=True) - 1,
                       min=0)


def scan_exact(rec, starts, k: int) -> bool:
    """`rec_by_scan` against the row gather it replaces, to the bit."""
    got = rec_by_scan(rec, starts, k)
    ref = rec[run_index(starts, k)]
    ref[:int(starts[0])] = 0
    return bool(torch.equal(got, ref))


def r11(device=None, iters: int = 20, warmup: int = 3, emit=None) -> dict:
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    n, k = R11_N, R11_K
    d = {name: torch.from_numpy(x).to(dev) for name, x in r11_data(n, k).items()}
    keys, vals, rec, starts, gidx = (d[x] for x in ("keys", "vals", "rec",
                                                    "starts", "gidx"))
    ten = torch.cat([vals[:, None], rec], dim=1)  # the 9 carried operands
    exact = scan_exact(rec, starts, k)
    emit(probe="r11", scan_exact=exact, n=n, k=k, card=card)
    z0 = torch.zeros((k, 8), dtype=I32, device=dev)
    fns = {
        f"sort 2-op over n={n}": lambda: sort_carry(keys, vals),
        f"sort 10-op over n={n}": lambda: sort_carry(keys, ten),
        "row-8 scatter n->k at sorted unique idx":
            lambda: _scatter_add(k, starts, rec),
        f"[{k}, 8] int32 blocked cumsum": lambda: blocked_cumsum(z0),
        f"row-8 gather [n]->[k={k}] (current rec path)": lambda: rec[gidx.long()],
        "rec_by_scan (deltas, scatter, cumsum)":
            lambda: rec_by_scan(rec, starts, k),
    }
    lines = {}
    for name, fn in fns.items():
        line = {"probe": "r11", "stage": name,
                **measure(fn, dev, iters, warmup)}
        line.pop("top", None)
        emit(**line, card=card)
        lines[name] = line
    return {"lines": lines, "scan_exact": exact, "card": card}


PROBES = {"r06": r06, "r08": r08, "r11": r11}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for name in argv or PROBES:
        PROBES[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
