"""Layout probes with kernels M1 (block sum) and M2 (transpose): port of
perf/micro3_r02.py.

The probes ask what a layout costs: a row-major gather of the payload
tables ([K, 8] f32 and [K, 16] bf16) against a gather that materialises
the channel-major [C, K] layout the blend kernels read (the step of
`rasterize.GatherExpand.forward`: `pay_f32[g].T.contiguous()`), a
transpose alone, and a row-major gather plus the hand-written transpose
M2; then scalar scatters and a counting-merge searchsorted against the
library's.

`psum_consume` replaces the Pallas kernel `_sum_kernel`
(micro3_r02.py:56, launched by `psum_consume`:60): the float32 sum of every
element, the consumer that makes each probe materialise its layout. On a
CUDA tensor it launches `csrc/blocksum.cu` (M1); on a CPU tensor it runs
`psum_consume_ref`, the plain version, which sums each 2^17-long block
along the long axis as the JAX function does and then the block sums.
`transpose` replaces `_tr_kernel` (:107, launched by `pallas_transpose`
:111): [K, C] -> [C, K] bit for bit, `csrc/transpose.cu` (M2) on CUDA
tensors, `transpose_ref` (`x.t().contiguous()`) on CPU tensors. Neither
falls back from the kernel to the plain version.

Domain: the JAX functions cut their grid at K // block and silently leave
the tail out (micro3_r02.py:63-68, 115). The port accepts only shapes they
sum or transpose completely -- K a positive multiple of 2^17 (M1) or of
2^14 (M2), float32 or bfloat16 -- and raises on others. M2 also takes at
most 64 columns (its slab of rows must fit 48 KB of shared memory).

Run on the card:  python -m vegs_torch.perf.micro3 [name ...]
(one JSON line per probe: its name, its stream ms by CUDA events and the
card's own ms by torch.profiler (`timing.measure`), its value, the card)
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, resolve_device
from .timing import device_line, measure

K = 1 << 21
N = 500_000
PSUM_BLOCK = 1 << 17       # psum_consume's block along the long axis
TRANSPOSE_BLOCK = 1 << 14  # pallas_transpose's rows per block
DTYPES = (torch.float32, torch.bfloat16)
MAX_TRANSPOSE_COLS = 64


def _check(x: torch.Tensor, block: int, what: str) -> int:
    """The long axis of `x` if the JAX function covers all of it."""
    if x.dim() != 2 or x.dtype not in DTYPES:
        raise ValueError(f"{what}: need a 2-D float32 or bfloat16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    k = max(x.shape)
    if k == 0 or k % block:
        raise ValueError(f"{what}: the long axis ({k}) must be a positive "
                         f"multiple of {block}; the JAX function leaves "
                         "the tail out")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return k


def _kernel_input(x: torch.Tensor, what: str) -> None:
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel reads a contiguous, 16-byte "
                         "aligned tensor")


def psum_parts_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of M1's blocks: [nblk] float32 sums of the 2^17-long
    blocks along the long axis of [K, C] (row blocks, when K > C) or
    [C, K] (column blocks), as the JAX grid cuts them."""
    k = _check(x, PSUM_BLOCK, "psum_consume")
    xf = x.float()
    if x.shape[0] > x.shape[1]:
        return xf.reshape(k // PSUM_BLOCK, -1).sum(dim=1)
    return xf.reshape(x.shape[0], k // PSUM_BLOCK, PSUM_BLOCK).sum(dim=(0, 2))


def psum_consume_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of M1: the sum of the block sums, 0-d float32."""
    return psum_parts_ref(x).sum()


def psum_consume(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of every element of x ([K, C] or [C, K], f32 or
    bf16), 0-d. CUDA tensors launch M1; CPU tensors run
    `psum_consume_ref`."""
    _check(x, PSUM_BLOCK, "psum_consume")
    if x.device.type == "cpu":
        return psum_consume_ref(x)
    _kernel_input(x, "psum_consume")
    fn = kernels.load("blocksum").vegs_blocksum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    nvec = x.numel() * x.element_size() // 16
    nparts = min(1024, -(-nvec // 256))
    parts = torch.empty((nparts,), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), nvec, int(x.dtype == torch.bfloat16),
                 parts.data_ptr(), nparts, out.data_ptr(), stream)
    kernels.check(err, "blocksum")
    psum_consume.launches += 1
    return out


psum_consume.launches = 0  # M1 launches: incremented where it launches


def _check_transpose(x: torch.Tensor) -> None:
    _check(x, TRANSPOSE_BLOCK, "transpose")
    if x.shape[0] % TRANSPOSE_BLOCK or not 1 <= x.shape[1] <= MAX_TRANSPOSE_COLS:
        raise ValueError(f"transpose: need [K, C] with K a multiple of "
                         f"{TRANSPOSE_BLOCK} and 1 <= C <= "
                         f"{MAX_TRANSPOSE_COLS}, got {tuple(x.shape)}")


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of M2: [K, C] -> [C, K]."""
    _check_transpose(x)
    return x.t().contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """[K, C] -> [C, K] (f32 or bf16), bit for bit. CUDA tensors launch
    M2; CPU tensors run `transpose_ref`."""
    _check_transpose(x)
    if x.device.type == "cpu":
        return transpose_ref(x)
    _kernel_input(x, "transpose")
    fn = kernels.load("transpose").vegs_transpose
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    k, c = x.shape
    out = torch.empty((c, k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), k, c, x.element_size(), out.data_ptr(),
                 stream)
    kernels.check(err, "transpose")
    transpose.launches += 1
    return out


transpose.launches = 0  # M2 launches: incremented where it launches


# -- the probes ---------------------------------------------------------------

class Data(NamedTuple):
    """The probes' inputs (micro3_r02.py:20-30, 134-159)."""
    k: int
    n: int
    a8: torch.Tensor     # [k, 8] f32
    a16: torch.Tensor    # [k, 16] bf16
    gidx: torch.Tensor   # [k] int64, in [0, n)
    tbl8: torch.Tensor   # [n + 1, 8] f32
    tbl16: torch.Tensor  # [n + 1, 16] bf16
    cum: torch.Tensor    # [n] int32 sorted, in [0, k)
    pos_f: torch.Tensor  # [n] int64 sorted unique positions in [0, k)
    vals_f: torch.Tensor  # [n] f32
    pos_i: torch.Tensor  # [n] int64 sorted unique positions in [0, k)
    vals_i: torch.Tensor  # [n] int32 in [0, 1000)


def make_data(device=None, k: int = K, n: int = N, seed: int = 0) -> Data:
    """The JAX module's inputs from numpy.random.default_rng(seed), drawn in
    its order (the module's tables and `CUM` at import, then the two scatter
    probes' positions and values as `ALL` runs them), on `device` (the card
    unless device="cpu")."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    a8 = rng.standard_normal((k, 8), dtype=np.float32)
    a16 = rng.standard_normal((k, 16), dtype=np.float32)
    gidx = rng.integers(0, n, k).astype(np.int32)
    tbl8 = rng.standard_normal((n + 1, 8), dtype=np.float32)
    tbl16 = rng.standard_normal((n + 1, 16), dtype=np.float32)
    cum = np.sort(rng.integers(0, k, n)).astype(np.int32)
    pos_f = np.sort(rng.choice(k, n, replace=False)).astype(np.int32)
    vals_f = rng.standard_normal(n).astype(np.float32)
    pos_i = np.sort(rng.choice(k, n, replace=False)).astype(np.int32)
    vals_i = rng.integers(0, 1000, n).astype(np.int32)

    def t(x, dtype=None):
        x = torch.from_numpy(x)
        return (x if dtype is None else x.to(dtype)).to(device)

    return Data(k=k, n=n, a8=t(a8), a16=t(a16, torch.bfloat16),
                gidx=t(gidx, torch.int64), tbl8=t(tbl8),
                tbl16=t(tbl16, torch.bfloat16), cum=t(cum),
                pos_f=t(pos_f, torch.int64), vals_f=t(vals_f),
                pos_i=t(pos_i, torch.int64), vals_i=t(vals_i))


def t_gather_rowmajor(d: Data):
    def step(args):
        t8, t16, idx = args
        return psum_consume(t8[idx]) + psum_consume(t16[idx])
    return step, (d.tbl8, d.tbl16, d.gidx)


def t_gather_transposed(d: Data):
    def step(args):
        t8, t16, idx = args
        return (psum_consume(t8[idx].t().contiguous())
                + psum_consume(t16[idx].t().contiguous()))
    return step, (d.tbl8, d.tbl16, d.gidx)


def t_xla_transpose_only(d: Data):
    def step(args):
        a8, a16 = args
        return (psum_consume(a8.t().contiguous())
                + psum_consume(a16.t().contiguous()))
    return step, (d.a8, d.a16)


def t_pallas_transpose(d: Data):
    def step(args):
        a8, a16 = args
        return psum_consume(transpose(a8)) + psum_consume(transpose(a16))
    return step, (d.a8, d.a16)


def t_scatter_scalar_unique(d: Data):
    def step(args):
        pos, vals = args
        z = torch.zeros((d.k,), dtype=torch.float32, device=vals.device)
        z[pos] = vals
        return z[:8].sum()
    return step, (d.pos_f, d.vals_f)


def t_scatter_int_unique(d: Data):
    def step(args):
        pos, vals = args
        z = torch.zeros((d.k,), dtype=torch.int32, device=vals.device)
        z[pos] = vals
        return torch.cumsum(z, dim=0, dtype=torch.int32)[-1].float()
    return step, (d.pos_i, d.vals_i)


def t_merge_searchsorted(d: Data):
    """searchsorted(cum, iota, right) by a counting merge: sort the queries
    (odd keys) into the sorted values (even keys), read each query's rank."""
    k, n = d.k, d.n

    def step(args):
        (cum,) = args
        dev = cum.device
        keys = torch.cat([cum * 2,
                          torch.arange(k, dtype=torch.int32, device=dev) * 2 + 1])
        tags = torch.cat([torch.zeros((n,), dtype=torch.int32, device=dev),
                          torch.ones((k,), dtype=torch.int32, device=dev)])
        _, perm = torch.sort(keys, stable=True)
        isq = tags[perm]
        rankq = torch.cumsum(isq, dim=0) - isq
        res = torch.arange(n + k, device=dev) - rankq
        ck = torch.where(isq == 1, rankq, torch.full_like(rankq, k + n))
        _, perm2 = torch.sort(ck, stable=True)
        return res[perm2][:k][:8].sum().float()
    return step, (d.cum,)


def t_xla_searchsorted_control(d: Data):
    slot = torch.arange(d.k, dtype=torch.int32, device=d.cum.device)

    def step(args):
        (cum,) = args
        g = torch.searchsorted(cum, slot, right=True)
        return g[:8].sum().float()
    return step, (d.cum,)


ALL = {
    "gather_mixed_rowmajor_psum": t_gather_rowmajor,
    "gather_mixed_transposed_psum": t_gather_transposed,
    "xla_transpose_only_psum": t_xla_transpose_only,
    "pallas_transpose_both": t_pallas_transpose,
    "scatter_scalar_unique_sorted_500k_2M": t_scatter_scalar_unique,
    "scatter_int_unique_sorted_500k_2M": t_scatter_int_unique,
    "merge_searchsorted_iota_queries": t_merge_searchsorted,
    "xla_searchsorted_control": t_xla_searchsorted_control,
}


def run(names=None, device=None, iters: int = 20, warmup: int = 3,
        emit=None, data: Data | None = None) -> list[dict]:
    """Time each probe (all of `ALL` by default) on `device` (the card
    unless device="cpu") and emit one dict per probe: its name, ms (CUDA
    events; cpu_ms on the CPU) and value."""
    dev = resolve_device(device)
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    card = device_line(dev)
    d = data if data is not None else make_data(dev)
    out = []
    for name in names or list(ALL):
        step, args = ALL[name](d)
        with torch.no_grad():
            t = measure(lambda: step(args), dev, iters, warmup)
            value = float(step(args))
        line = {"probe": name, **t, "value": value, "k": d.k, "n": d.n,
                "card": card}
        emit(**line)
        out.append(line)
    return out


if __name__ == "__main__":
    run(sys.argv[1:] or None)
