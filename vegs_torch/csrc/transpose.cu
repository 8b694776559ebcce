// M2: [K, C] -> [C, K] transpose for Hopper, f32 or bf16, bit-exact.
//
// Replaces the Pallas kernel perf/micro3_r02.py:_tr_kernel (107), launched
// by pallas_transpose (111) in blocks of 2^14 rows: the layout step of a
// row-major payload gather followed by a channel-major consumer (the
// gather's `pay_f32[g].T.contiguous()` in vegs_torch/ops/rasterize.py).
//
// Bound on this card: no arithmetic, one read and one write of every
// element, so the bytes bound it (2 x K x C x element size; 134 MB at
// K = 2^21 for f32 C = 8 or bf16 C = 16, 0.040 ms at 3.35 TB/s).
//
// Design: one CTA per slab of `rows` rows. The slab is rows x C contiguous
// elements, read with coalesced 16-byte loads and scattered into shared
// memory as [rows][C + 1] (the pad makes the column reads below free of
// bank conflicts). Channel c of the slab is then `rows` contiguous elements
// of the output; neighbouring threads write neighbouring 32-bit words (one
// f32, or two bf16 of neighbouring rows), so the stores coalesce. Elements
// are copied as bits: no float arithmetic. The TPU's 2^14-row blocks are
// not carried over; `rows` is the largest power of two up to 1024 whose
// tile fits 48 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
transpose_kernel(const T* __restrict__ x, int64_t k, int c, int rows,
                 T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int stride = c + 1;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;

  constexpr int PER_VEC = 16 / sizeof(T);
  const uint4* src = reinterpret_cast<const uint4*>(x + r0 * c);
  const int nvec = rows * c / PER_VEC;
  for (int v = threadIdx.x; v < nvec; v += THREADS) {
    const uint4 q = src[v];
    const T* e = reinterpret_cast<const T*>(&q);
    int r = v * PER_VEC / c;
    int ch = v * PER_VEC - r * c;
#pragma unroll
    for (int j = 0; j < PER_VEC; ++j) {
      tile[r * stride + ch] = e[j];
      if (++ch == c) {
        ch = 0;
        ++r;
      }
    }
  }
  __syncthreads();

  constexpr int PACK = 4 / sizeof(T);
  const int words_per_row = rows / PACK;
  const int nwords = words_per_row * c;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out);
  for (int w = threadIdx.x; w < nwords; w += THREADS) {
    const int ch = w / words_per_row;
    const int r = (w - ch * words_per_row) * PACK;
    uint32_t word;
    T* p = reinterpret_cast<T*>(&word);
#pragma unroll
    for (int j = 0; j < PACK; ++j) p[j] = tile[(r + j) * stride + ch];
    dst[(static_cast<int64_t>(ch) * k + r0 + r) / PACK] = word;
  }
}

}  // namespace

// x [k, c] contiguous, 16-byte aligned; out [c, k]. elem_bytes is 4 (f32)
// or 2 (bf16); k must be a multiple of the slab (any multiple of 1024 is).
extern "C" int vegs_transpose(const void* x, int64_t k, int c, int elem_bytes,
                              void* out, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rows = 1024;
  while (rows > 8 && static_cast<int64_t>(rows) * (c + 1) * elem_bytes > MAX_SMEM) {
    rows /= 2;
  }
  const size_t smem = static_cast<size_t>(rows) * (c + 1) * elem_bytes;
  if (smem > MAX_SMEM || k % rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(k / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    transpose_kernel<uint32_t><<<blocks, THREADS, smem, s>>>(
        static_cast<const uint32_t*>(x), k, c, rows,
        static_cast<uint32_t*>(out));
  } else {
    transpose_kernel<uint16_t><<<blocks, THREADS, smem, s>>>(
        static_cast<const uint16_t*>(x), k, c, rows,
        static_cast<uint16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
