"""The payload gather's backward: CUDA kernel K3 and its plain PyTorch
versions (port of vegs_tpu/ops/segreduce.py and of the reduction in
vegs_tpu/ops/rasterize.py:_ge_bwd).

The gather (`rasterize.GatherExpand`) copies each Gaussian's payload rows
to the padded slots of its instances; its backward sums the per-instance
cotangents back onto each Gaussian. Binning gives the map: Gaussian g owns
the raw rows [ends[g-1], ends[g]) and raw row r is padded slot `order[r]`
(dead when order[r] >= k_pad).

`gather_expand_bwd` is that backward whole, on the main path: on CUDA
tensors it launches the hand-written kernels in `csrc/segreduce.cu` (a
coalesced pass that stages the channel-major cotangents slot-major, then
one thread per Gaussian reading its rows through `order`, long segments
summed by a whole warp, row-major outputs; bound by the bytes it moves --
see the source note there); on CPU tensors it runs `gather_expand_bwd_ref`, the
plain version. `segment_reduce_cols` keeps the JAX package's contract
(channel-major columns already in raw order) and replaces the Pallas
kernel `_kernel` (vegs_tpu/ops/segreduce.py:46, launched by
`segment_reduce_cols`:120): the same kernel source with another fetch and
store on CUDA tensors, `segment_reduce_ref` (an `index_add_` of every
column onto its segment) on CPU tensors. Each entry counts its own
launches. Segments longer than 32 rows (`LONG_ROWS` in the source) are
summed by a whole warp. The TPU layout constraints of the Pallas kernel
(segments in blocks of 512, K a multiple of 128, the membership matmul)
are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

F32_COLS, AUX_COLS = 8, 16


def segment_reduce_ref(cols: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3's JAX contract: [C, K] f32, [NG]
    starts/ends -> [C, NG]. Each column k is added to the segment g with
    starts[g] <= k < ends[g] (the last such g when empty segments share the
    start); columns outside every segment are dropped."""
    k = cols.shape[1]
    col = torch.arange(k, device=cols.device)
    seg = torch.searchsorted(starts.long(), col, right=True) - 1
    seg_c = seg.clamp(min=0)
    inside = (seg >= 0) & (col < ends.long()[seg_c])
    out = torch.zeros((cols.shape[0], starts.shape[0]), dtype=torch.float32,
                      device=cols.device)
    out.index_add_(1, seg_c[inside], cols[:, inside])
    return out


def cotangent_columns(d_pf, d_pa, order, ends):
    """The JAX contract's inputs from the cotangents of the gathered
    payload (d_pf [8, k_pad] f32, d_pa [16, k_pad]): the [24, kr] f32
    columns in raw (Gaussian-grouped) order -- column r is slot `order[r]`,
    zero where the row is dead (order >= k_pad), the aux half upcast -- and
    each Gaussian's segment [starts, ends) of them."""
    k = d_pf.shape[1]
    dead = order >= k
    idx = torch.where(dead, torch.zeros_like(order), order).long()
    cols = torch.cat([d_pf[:, idx], d_pa[:, idx].to(torch.float32)])
    cols = torch.where(dead[None, :], torch.zeros((), device=cols.device),
                       cols).contiguous()
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return cols, starts, ends.contiguous()


def gather_expand_bwd_ref(d_pf, d_pa, order, ends):
    """Plain PyTorch version of `gather_expand_bwd`: `segment_reduce_ref`
    of `cotangent_columns`, transposed to row-major and the aux half cast
    to d_pa's dtype (round to nearest even)."""
    out = segment_reduce_ref(*cotangent_columns(d_pf, d_pa, order, ends))
    return (out[:F32_COLS].T.contiguous(),
            out[F32_COLS:].T.contiguous().to(d_pa.dtype))


def _check_devices(*ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _contiguous(*ts):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _entry(symbol: str, argtypes):
    fn = getattr(kernels.load("segreduce"), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _check_gather_bwd(d_pf, d_pa, order, ends):
    if d_pf.dtype != torch.float32 or d_pf.ndim != 2 or d_pf.shape[0] != F32_COLS:
        raise ValueError("d_pf must be [8, k_pad] float32")
    if (d_pa.dtype not in (torch.float32, torch.bfloat16)
            or tuple(d_pa.shape) != (AUX_COLS, d_pf.shape[1])):
        raise ValueError("d_pa must be [16, k_pad] float32 or bfloat16")
    if (order.dtype != torch.int32 or ends.dtype != torch.int32
            or order.ndim != 1 or ends.ndim != 1):
        raise ValueError("order and ends must be 1-D int32")
    _check_devices(d_pf, d_pa, order, ends)


def _launch_gather_bwd(d_pf, d_pa, order, ends):
    _contiguous(d_pf, d_pa, order, ends)
    fn = _entry("vegs_gather_expand_bwd",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p])
    ng, k_pad = ends.shape[0], d_pf.shape[1]
    dev = d_pf.device
    dpf = torch.empty((ng, F32_COLS), dtype=torch.float32, device=dev)
    dpa = torch.empty((ng, AUX_COLS), dtype=d_pa.dtype, device=dev)
    if ng == 0:
        return dpf, dpa
    # the first pass's slot-major rows: 8 f32 and 16 aux cotangents a slot
    rows = torch.empty((k_pad, 32 + 16 * d_pa.element_size()),
                       dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(d_pf.data_ptr(), d_pa.data_ptr(),
                 int(d_pa.dtype == torch.bfloat16), k_pad,
                 order.data_ptr(), ends.data_ptr(), ng, rows.data_ptr(),
                 dpf.data_ptr(), dpa.data_ptr(), stream)
    kernels.check(err, "vegs_gather_expand_bwd")
    return dpf, dpa


def gather_expand_bwd(d_pf: torch.Tensor, d_pa: torch.Tensor,
                      order: torch.Tensor, ends: torch.Tensor):
    """The payload gather's backward: per Gaussian g, the sum over its live
    raw rows r in [ends[g-1], ends[g]) of the cotangents of slot order[r].

    d_pf [8, k_pad] f32 and d_pa [16, k_pad] (bf16 or f32) channel-major,
    order [kr] int32 (k_pad = a dead row), ends [ng] int32 monotone ->
    (dpay_f32 [ng, 8] f32, dpay_aux [ng, 16] in d_pa's dtype), row-major
    and contiguous; the sums run in float32 and the aux half is rounded
    once. CUDA tensors launch K3 (the cotangents staged slot-major, then
    the reduce); CPU tensors run `gather_expand_bwd_ref`."""
    _check_gather_bwd(d_pf, d_pa, order, ends)
    if d_pf.device.type == "cpu":
        return gather_expand_bwd_ref(d_pf, d_pa, order, ends)
    if d_pf.device.type != "cuda":
        raise ValueError(f"no gather backward kernel for device {d_pf.device}")
    out = _launch_gather_bwd(d_pf, d_pa, order, ends)
    gather_expand_bwd.launches += 1
    return out


gather_expand_bwd.launches = 0  # K3 launches on the main path


def segment_reduce_cols(cols: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """out[c, g] = sum of cols[c, k] over k in [starts[g], ends[g]).

    cols [C, K] float32 channel-major; starts/ends [NG] int32, monotone,
    ends <= K; empty segments allowed. Sums run in float32 in column order
    (segments over 32 columns: by a warp, lane-strided, then a fixed
    shuffle tree). CUDA tensors launch K3; CPU tensors run
    `segment_reduce_ref`."""
    if cols.dtype != torch.float32 or cols.dim() != 2:
        raise ValueError("cols must be [C, K] float32")
    if (starts.dtype != torch.int32 or ends.dtype != torch.int32
            or starts.dim() != 1 or starts.shape != ends.shape):
        raise ValueError("starts and ends must be [NG] int32 of one shape")
    _check_devices(cols, starts, ends)
    if cols.device.type == "cpu":
        return segment_reduce_ref(cols, starts, ends)
    if cols.device.type != "cuda":
        raise ValueError(f"no segment-reduce kernel for device {cols.device}")
    _contiguous(cols, starts, ends)
    fn = _entry("vegs_segment_reduce",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_void_p])
    c, k = cols.shape
    ng = starts.shape[0]
    dev = cols.device
    out = torch.empty((c, ng), dtype=torch.float32, device=dev)
    if ng == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), c, k, starts.data_ptr(), ends.data_ptr(),
                 ng, out.data_ptr(), stream)
    kernels.check(err, "vegs_segment_reduce")
    segment_reduce_cols.launches += 1
    return out


segment_reduce_cols.launches = 0  # K3 launches in the JAX contract


def span_stats(ends: torch.Tensor) -> dict:
    """The segments' spans (rows per Gaussian) from `ends`: the count, the
    share that is empty, the mean, the 99th percentile, the largest, and
    how many segments are longer than 8, 16, ..., 256 rows."""
    span = torch.diff(ends.long(), prepend=ends.new_zeros(1).long())
    ordered = torch.sort(span).values
    return {"segments": int(span.numel()),
            "empty_share": float((span == 0).double().mean()),
            "mean": float(span.double().mean()),
            "p99": int(ordered[(span.numel() - 1) * 99 // 100]),
            "max": int(ordered[-1]),
            "longer_than": {m: int((span > m).sum())
                            for m in (8, 16, 32, 64, 128, 256)}}


def kernel_info(aux_dtype: torch.dtype) -> dict:
    """The main path's K3 for this aux dtype, as the CUDA runtime reports
    it (`kernels.kernel_info`). Needs a card."""
    return kernels.kernel_info("segreduce", int(aux_dtype == torch.bfloat16))
