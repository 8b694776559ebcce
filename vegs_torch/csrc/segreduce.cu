// K3: the payload gather's backward for Hopper -- the cotangent rows of the
// padded layout summed onto their Gaussians.
//
// Replaces the Pallas kernel vegs_tpu/ops/segreduce.py:_kernel (46),
// launched by segment_reduce_cols (120) from the payload gather's backward
// (vegs_tpu/ops/rasterize.py:_ge_bwd, 220). Gaussian g owns the raw rows
// [ends[g-1], ends[g]); row r is padded slot order[r] (dead when order[r]
// >= k_pad). The main path's entry (`vegs_gather_expand_bwd`) sums, per
// Gaussian, the 8 f32 cotangents d_pf[c, slot] and the 16 aux cotangents
// d_pa[c, slot] (upcast) of its live rows in float32 and writes them as its
// rows of dpay_f32 [ng, 8] f32 and dpay_aux [ng, 16] (the aux dtype,
// rounded once to nearest even), in two launches. The JAX contract
// (`vegs_segment_reduce`: out[c, g] = sum of cols[c, k] over k in
// [starts[g], ends[g]), channel-major) runs the same reduce with another
// fetch and store policy.
//
// Bound on this card: one add per summed value, so the bytes bound it:
// each live row's 8 + 16 cotangents and its order entry read once, the
// segment ends, and each Gaussian's two output rows written once.
//
// Design: the cotangents arrive channel-major (K2's layout), so one row's
// 24 values lie in 24 sectors, and a row read through `order` straight
// from them costs 24 scattered sectors over a ~150 MB working set that L2
// (50 MB) cannot hold: measured on an H100 at the first training step's
// 1.93M rows, as slow as the gathers it replaced (PERF.md). So a first,
// coalesced pass (rows_kernel) stages them slot-major, one 16-byte-aligned
// row per slot (64 bytes with a bf16 aux half), and the reduce reads two
// or four 16-byte words per row. The reduce: one thread per segment; a
// warp takes 32 consecutive Gaussians, so the segment bounds are read
// once, coalesced, and the rows of neighbouring Gaussians are neighbouring
// raw rows. A lane sums its own segment in raw order when it is at most
// LONG_ROWS rows long; each longer segment is summed by the whole warp in
// turn -- lane l takes rows s + l, s + l + 32, ... in order, then a fixed
// xor-shuffle tree combines the lanes -- so one Gaussian covering many
// tiles does not keep a lane serial while the others idle. No atomics: the
// sums are the same from run to run. Each Gaussian's 32-byte f32 row and
// its aux row go out as whole 16-byte stores. No [24, kr] column matrix is
// gathered, upcast, transposed or cast around the kernel. The TPU design
// (segments in blocks of 512 with a double-buffered column stream and a
// membership matmul) is not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splat.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // 64 registers a thread: 32 warps an SM
constexpr int NCH = 24;  // sums per segment: 8 f32 and 16 aux channels
constexpr int F32_CH = 8;
constexpr int AUX_CH = 16;
// Segments longer than this many rows are summed by a whole warp. At the
// reference scale no segment is longer than 16 rows, and the time does not
// move between 8 and never (PERF.md).
constexpr int LONG_ROWS = 32;

using vegs::to_f32;

// 16-byte words of one slot's staged cotangent row: 8 f32, then 16 aux.
template <typename AuxT>
__host__ __device__ constexpr int row_words() {
  return (F32_CH * 4 + AUX_CH * static_cast<int>(sizeof(AuxT))) / 16;
}

__device__ __forceinline__ uint32_t pack_aux(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The first pass of the main path: slot s's 8 f32 and 16 aux cotangents,
// read coalesced from the channel-major d_pf and d_pa, written as one
// 16-byte-aligned row (64 bytes in bf16, 96 in f32) of `rows`.
template <typename AuxT>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ d_pf, const AuxT* __restrict__ d_pa,
            int64_t k_pad, uint4* __restrict__ rows) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (s >= k_pad) return;
  uint4* dst = rows + s * row_words<AuxT>();
  uint32_t f[F32_CH];
#pragma unroll
  for (int c = 0; c < F32_CH; ++c) f[c] = __float_as_uint(d_pf[c * k_pad + s]);
  dst[0] = make_uint4(f[0], f[1], f[2], f[3]);
  dst[1] = make_uint4(f[4], f[5], f[6], f[7]);
  uint32_t a[row_words<AuxT>() * 4 - F32_CH];
  if constexpr (sizeof(AuxT) == 2) {
#pragma unroll
    for (int i = 0; i < AUX_CH / 2; ++i)
      a[i] = pack_aux(d_pa[2 * i * k_pad + s], d_pa[(2 * i + 1) * k_pad + s]);
  } else {
#pragma unroll
    for (int c = 0; c < AUX_CH; ++c)
      a[c] = __float_as_uint(to_f32(d_pa[c * k_pad + s]));
  }
#pragma unroll
  for (int i = 0; i < row_words<AuxT>() - 2; ++i)
    dst[2 + i] = make_uint4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
}

// The main path's fetch and store: each raw row r reads slot order[r] from
// the staged rows (two 16-byte words of f32, two or four of aux), and each
// Gaussian's sums go to row-major [ng, 8] and [ng, 16].
template <typename AuxT>
struct GatherBwd {
  const uint4* rows;  // [k_pad, row_words]
  int64_t k_pad;
  const int* order;   // [kr]
  const int* ends;    // [ng]
  float* dpf;         // [ng, 8]
  AuxT* dpa;          // [ng, 16]

  __device__ __forceinline__ int seg_start(int64_t g) const {
    return g == 0 ? 0 : ends[g - 1];
  }
  __device__ __forceinline__ int seg_end(int64_t g) const { return ends[g]; }
  __device__ __forceinline__ void add(float* acc, int r) const {
    const int slot = order[r];
    if (slot < 0 || slot >= k_pad) return;  // a dead row
    const uint4* src = rows + static_cast<int64_t>(slot) * row_words<AuxT>();
    uint32_t w[row_words<AuxT>() * 4];
#pragma unroll
    for (int i = 0; i < row_words<AuxT>(); ++i) {
      const uint4 v = src[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < F32_CH; ++c)
      acc[c] = __fadd_rn(acc[c], __uint_as_float(w[c]));
#pragma unroll
    for (int c = 0; c < AUX_CH; ++c) {
      float x;
      if constexpr (sizeof(AuxT) == 2) {  // bf16 -> f32 is exact: a shift
        const uint32_t u = w[F32_CH + c / 2];
        x = __uint_as_float(c % 2 ? (u & 0xffff0000u) : (u << 16));
      } else {
        x = __uint_as_float(w[F32_CH + c]);
      }
      acc[F32_CH + c] = __fadd_rn(acc[F32_CH + c], x);
    }
  }
  __device__ __forceinline__ void store(const float* acc, int64_t g) const {
    float4* f = reinterpret_cast<float4*>(dpf + g * F32_CH);
    f[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    f[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    store_aux(acc + F32_CH, dpa + g * AUX_CH);
  }
  __device__ __forceinline__ static void store_aux(const float* a, float* dst) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
  }
  __device__ __forceinline__ static void store_aux(const float* a,
                                                   __nv_bfloat16* dst) {
    // round each sum once, to nearest even (torch's .to(torch.bfloat16))
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = pack_aux(__float2bfloat16_rn(a[2 * i]),
                      __float2bfloat16_rn(a[2 * i + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
};

// The JAX contract's fetch and store: [C, k] channel-major columns summed
// over [starts[g], ends[g]) into [C, ng]; blockIdx.y takes channels
// [24 y, 24 y + 24).
struct Cols {
  const float* cols;
  int64_t k;
  int nch;
  const int* starts;
  const int* ends;
  int64_t ng;
  float* out;

  __device__ __forceinline__ int seg_start(int64_t g) const {
    return starts[g];
  }
  __device__ __forceinline__ int seg_end(int64_t g) const { return ends[g]; }
  __device__ __forceinline__ void add(float* acc, int r) const {
    const int c0 = blockIdx.y * NCH;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (c0 + c < nch)
        acc[c] = __fadd_rn(acc[c], cols[(c0 + c) * k + r]);
  }
  __device__ __forceinline__ void store(const float* acc, int64_t g) const {
    const int c0 = blockIdx.y * NCH;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (c0 + c < nch) out[(c0 + c) * ng + g] = acc[c];
  }
};

template <class P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
segreduce_kernel(P p, int64_t ng) {
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = g < ng;
  int s = 0, e = 0;
  if (live) {
    s = p.seg_start(g);
    e = p.seg_end(g);
  }
  const bool is_long = e - s > LONG_ROWS;
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  if (!is_long) {
    for (int r = s; r < e; ++r) p.add(acc, r);
    if (live) p.store(acc, g);
  }
  // the warp's long segments, one after another, by all 32 lanes; the
  // short sums are stored, so `acc` holds each lane's part
  const int64_t g0 = g - lane;
  for (unsigned longs = __ballot_sync(vegs::FULL_MASK, is_long); longs;
       longs &= longs - 1) {
    const int src = __ffs(longs) - 1;
    const int ls = __shfl_sync(vegs::FULL_MASK, s, src);
    const int le = __shfl_sync(vegs::FULL_MASK, e, src);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
    for (int r = ls + lane; r < le; r += 32) p.add(acc, r);
    // a fixed xor tree: every lane ends with the same 24 totals
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(vegs::FULL_MASK, acc[c], m));
    if (lane == src) p.store(acc, g0 + src);
  }
}

template <class P>
int launch(P p, int64_t ng, int groups, void* stream) {
  const dim3 grid(static_cast<unsigned>((ng + THREADS - 1) / THREADS), groups);
  segreduce_kernel<P><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, ng);
  return static_cast<int>(cudaGetLastError());
}

template <typename AuxT>
int gather_bwd(const float* d_pf, const void* d_pa, int64_t k_pad,
               const int* order, const int* ends, int64_t ng, void* rows,
               float* dpf, void* dpa, void* stream) {
  uint4* r = static_cast<uint4*>(rows);
  rows_kernel<AuxT><<<static_cast<unsigned>((k_pad + THREADS - 1) / THREADS),
                      THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      d_pf, static_cast<const AuxT*>(d_pa), k_pad, r);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch(GatherBwd<AuxT>{r, k_pad, order, ends, dpf,
                                static_cast<AuxT*>(dpa)},
                ng, 1, stream);
}

}  // namespace

// The main path's entry: d_pf [8, k_pad] f32 and d_pa [16, k_pad] (bf16 when
// aux_bf16, else f32) channel-major, order [kr] and ends [ng] int32 ->
// dpf [ng, 8] f32 and dpa [ng, 16] row-major (16-byte aligned). `rows`, a
// 16-byte-aligned scratch of k_pad * (32 + 16 * sizeof(aux)) bytes,
// receives the slot-major cotangents of the first pass.
extern "C" int vegs_gather_expand_bwd(const float* d_pf, const void* d_pa,
                                      int aux_bf16, int64_t k_pad,
                                      const int* order, const int* ends,
                                      int64_t ng, void* rows, float* dpf,
                                      void* dpa, void* stream) {
  if (aux_bf16)
    return gather_bwd<__nv_bfloat16>(d_pf, d_pa, k_pad, order, ends, ng, rows,
                                     dpf, dpa, stream);
  return gather_bwd<float>(d_pf, d_pa, k_pad, order, ends, ng, rows, dpf, dpa,
                           stream);
}

// The JAX contract: cols [c, k] f32 channel-major, starts/ends [ng] int32
// -> out [c, ng] f32.
extern "C" int vegs_segment_reduce(const float* cols, int c, int64_t k,
                                   const int* starts, const int* ends,
                                   int64_t ng, float* out, void* stream) {
  return launch(Cols{cols, k, c, starts, ends, ng, out}, ng,
                (c + NCH - 1) / NCH, stream);
}

// Registers per thread, shared memory per block (bytes), resident blocks
// per SM and local (spill) bytes per thread of the main path's kernel,
// into res[0..3].
extern "C" int vegs_segreduce_info(int aux_bf16, int* res) {
  return aux_bf16
             ? vegs::kernel_info(segreduce_kernel<GatherBwd<__nv_bfloat16>>,
                                 THREADS, 0, res)
             : vegs::kernel_info(segreduce_kernel<GatherBwd<float>>, THREADS, 0,
                                 res);
}
