// M1: the float32 sum of every element of a contiguous f32 or bf16 tensor,
// for Hopper.
//
// Replaces the Pallas kernel perf/micro3_r02.py:_sum_kernel (56), launched
// by psum_consume (60): a consumer that forces a layout to be materialised,
// summing each 2^17-long block along the long axis of a [K, C] or [C, K]
// array into one partial, then the partials. The total is the sum of every
// element in float32, whatever the layout.
//
// Bound on this card: one add per element and every element read once, so
// the bytes bound it (K x C x element size; 67 MB at K = 2^21 for f32 C = 8
// or bf16 C = 16, 0.020 ms at 3.35 TB/s).
//
// Design: the TPU grid has K / 2^17 blocks (16 at K = 2^21), which would
// fill 16 of the 132 SMs; it is not carried over. Pass 1 runs up to 1024
// CTAs (a number fixed by the size, not by the card); each thread sums a
// fixed strided set of 16-byte vectors in float32, four loads in flight per
// iteration, then the CTA adds its threads' sums with warp shuffles and
// writes one partial. Pass 2, one CTA, adds the partials in a fixed order.
// No atomics: repeated runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <bool BF16>
__device__ __forceinline__ float vec_sum(uint4 q) {
  if (BF16) {
    return ((bf16_lo(q.x) + bf16_hi(q.x)) + (bf16_lo(q.y) + bf16_hi(q.y))) +
           ((bf16_lo(q.z) + bf16_hi(q.z)) + (bf16_lo(q.w) + bf16_hi(q.w)));
  }
  return (__uint_as_float(q.x) + __uint_as_float(q.y)) +
         (__uint_as_float(q.z) + __uint_as_float(q.w));
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // the block's sum, in thread 0
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
blocksum_partials(const uint4* __restrict__ x, int64_t nvec,
                  float* __restrict__ parts) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  int64_t v = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  float acc = 0.0f;
  for (; v + 3 * step < nvec; v += 4 * step) {
    const uint4 a = x[v], b = x[v + step], c = x[v + 2 * step],
                d = x[v + 3 * step];
    acc += (vec_sum<BF16>(a) + vec_sum<BF16>(b)) +
           (vec_sum<BF16>(c) + vec_sum<BF16>(d));
  }
  for (; v < nvec; v += step) acc += vec_sum<BF16>(x[v]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) parts[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(THREADS)
blocksum_final(const float* __restrict__ parts, int nparts,
               float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += THREADS) acc += parts[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

// x: nvec 16-byte vectors of f32 (is_bf16 = 0) or bf16 elements, 16-byte
// aligned; parts: nparts (1..1024) floats of scratch; out: one float.
extern "C" int vegs_blocksum(const void* x, int64_t nvec, int is_bf16,
                             float* parts, int nparts, float* out,
                             void* stream) {
  if (nparts < 1 || nparts > 1024 || nvec < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  if (is_bf16) {
    blocksum_partials<true><<<nparts, THREADS, 0, s>>>(xv, nvec, parts);
  } else {
    blocksum_partials<false><<<nparts, THREADS, 0, s>>>(xv, nvec, parts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blocksum_final<<<1, THREADS, 0, s>>>(parts, nparts, out);
  return static_cast<int>(cudaGetLastError());
}
