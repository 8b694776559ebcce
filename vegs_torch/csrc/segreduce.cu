// K3: segment sum of raw-order gradient columns for Hopper.
//
// Replaces the Pallas kernel vegs_tpu/ops/segreduce.py:_kernel (46),
// launched by segment_reduce_cols (120) from the payload gather's backward
// (vegs_tpu/ops/rasterize.py:_ge_bwd, 220). out[c, g] is the sum of
// cols[c, k] over k in [starts[g], ends[g]): per-instance cotangents,
// gathered into raw (Gaussian-grouped) order, summed onto their Gaussian.
//
// Bound on this card: one add per input element, so the bytes bound it:
// every column is read once (C x K x 4 B), every sum written once
// (C x NG x 4 B), plus the segment bounds.
//
// Design: one thread per (channel, segment); blockIdx.y is the channel.
// Neighbouring threads own neighbouring segments, whose spans are
// neighbouring column ranges, so a warp's loads of one channel row fall on
// neighbouring addresses and its stores are contiguous. Each thread sums its
// span in column order in float32, so the result does not change from run
// to run. No atomics, no shared memory. At the reference scale a segment
// averages about one column; a Gaussian with a long span keeps one thread
// busy longer, which this simple version accepts. The TPU design (segments
// in blocks of 512 with a double-buffered column stream and a membership
// matmul) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
segreduce_kernel(const float* __restrict__ cols, int64_t k,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 int64_t ng, float* __restrict__ out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (g >= ng) return;
  const int64_t c = blockIdx.y;
  const float* row = cols + c * k;
  const int e = ends[g];
  float acc = 0.0f;
  for (int i = starts[g]; i < e; ++i) acc += row[i];
  out[c * ng + g] = acc;
}

}  // namespace

extern "C" int vegs_segment_reduce(const float* cols, int c, int64_t k,
                                   const int* starts, const int* ends,
                                   int64_t ng, float* out, void* stream) {
  const dim3 grid(static_cast<unsigned>((ng + THREADS - 1) / THREADS), c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segreduce_kernel<<<grid, THREADS, 0, s>>>(cols, k, starts, ends, ng, out);
  return static_cast<int>(cudaGetLastError());
}
