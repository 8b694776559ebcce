"""Segment sum of raw-order gradient columns: CUDA kernel K3 and its plain
PyTorch version (port of vegs_tpu/ops/segreduce.py).

The reduction half of the payload gather's backward
(`rasterize.GatherExpand`): the per-instance cotangents, gathered into raw
(Gaussian-grouped) order as channel-major columns, are summed per Gaussian
over its contiguous column range [starts[g], ends[g]).

`segment_reduce_cols` replaces the Pallas kernel `_kernel`
(vegs_tpu/ops/segreduce.py:46, launched by `segment_reduce_cols`:120). On a
CUDA tensor it launches the hand-written kernel in `csrc/segreduce.cu` (one
thread per (channel, segment), summing its span in column order -- see the
source note there: the kernel is bound by the bytes it streams). On a CPU
tensor it runs `segment_reduce_ref`, the plain version: an `index_add_` of
every column onto its segment. The TPU layout constraints of the Pallas
kernel (segments in blocks of 512, K a multiple of 128, the membership
matmul) are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def segment_reduce_ref(cols: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: [C, K] f32, [NG] starts/ends -> [C, NG].
    Each column k is added to the segment g with starts[g] <= k < ends[g]
    (the last such g when empty segments share the start); columns outside
    every segment are dropped."""
    k = cols.shape[1]
    col = torch.arange(k, device=cols.device)
    seg = torch.searchsorted(starts.long(), col, right=True) - 1
    seg_c = seg.clamp(min=0)
    inside = (seg >= 0) & (col < ends.long()[seg_c])
    out = torch.zeros((cols.shape[0], starts.shape[0]), dtype=torch.float32,
                      device=cols.device)
    out.index_add_(1, seg_c[inside], cols[:, inside])
    return out


def _check_inputs(cols, starts, ends):
    if cols.dtype != torch.float32 or cols.dim() != 2:
        raise ValueError("cols must be [C, K] float32")
    if (starts.dtype != torch.int32 or ends.dtype != torch.int32
            or starts.dim() != 1 or starts.shape != ends.shape):
        raise ValueError("starts and ends must be [NG] int32 of one shape")
    devs = {cols.device, starts.device, ends.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _launch(cols, starts, ends):
    for t in (cols, starts, ends):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    fn = kernels.load("segreduce").vegs_segment_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p]
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
    kernels.check(err, "segreduce")
    segment_reduce_cols.launches += 1
    return out


def segment_reduce_cols(cols: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """out[c, g] = sum of cols[c, k] over k in [starts[g], ends[g]).

    cols [C, K] float32 channel-major; starts/ends [NG] int32, monotone,
    ends <= K; empty segments allowed. Sums run in float32 in column order.
    CUDA tensors launch K3; CPU tensors run `segment_reduce_ref`."""
    _check_inputs(cols, starts, ends)
    if cols.device.type == "cpu":
        return segment_reduce_ref(cols, starts, ends)
    if cols.device.type != "cuda":
        raise ValueError(f"no segment-reduce kernel for device {cols.device}")
    return _launch(cols, starts, ends)


segment_reduce_cols.launches = 0  # K3 launches: incremented where it launches
