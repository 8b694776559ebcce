// K1: tile blend forward for Hopper.
//
// Replaces the Pallas kernel vegs_tpu/ops/blend_pallas.py:_fwd_kernel (201),
// launched by _blend_fwd_impl (464). It composites each tile's depth-sorted
// instance range front to back per pixel, per the spec in
// vegs_tpu/ops/blend_ref.py:16-31, into 11 accumulated channels (rgb, depth,
// quat, scale) plus the final transmittance.
//
// Bound on this card: per pixel the walk is a sequential recurrence with an
// early exit, so the work is (pixels x instances walked) of scalar fp32 math
// with two exps and a log1p each; the bytes are 64 B per instance slot
// (8 f32 + 16 bf16 rows) read once per tile and 48 B per pixel written. The
// operations bound it -- and most of them were wasted: ~91% of the walked
// (pixel, instance) pairs have alpha 0, yet each costs the splat exponent
// and an exp.
//
// Design: one block per tile, one thread per pixel, each warp on a compact
// 8x4 rectangle of the tile (csrc/splat.cuh: thread_pixel). The block
// stages 256 instances at a time in shared memory, the next batch with
// cp.async into a second buffer while the current one is walked, and
// computes each staged instance's conservative footprint box once
// (splat.cuh: footprint_box). Each warp then tests the batch 32 instances
// at a time against its rectangle, packs the hits in range order into a
// warp-private index list (__ballot_sync / __popc), and walks only that
// list: a skipped instance has alpha 0 at all of the warp's pixels, which
// the walk would have skipped too, so the output and the stop index do not
// change. Each thread carries log T (as the Pallas kernel does, so the
// T < 1e-4 stop agrees with it); a warp whose pixels have all stopped skips
// the rest of each batch, and the block leaves the range as soon as every
// pixel has stopped (__syncthreads_count). The cull is a template
// parameter: the C entry vegs_blend_fwd always runs it, and
// vegs_blend_fwd_nocull, with the cull compiled out, exists only for the
// bit-identity check and timing in chip_smoke.py. The TPU devices --
// triangular-matmul prefix sums, 8-tile programs, 256-slot DMA superchunks
// -- are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splat.cuh"

namespace {

constexpr int N_ACCUM = 11;   // output channel 11 is the final T
constexpr int MAX_THREADS = 1024;

using vegs::to_f32;

// Dynamic shared memory: two staging buffers, the current batch's boxes,
// one 256-entry index list per warp.
template <typename AuxT>
size_t smem_bytes(int nwarps) {
  return 2 * sizeof(vegs::Stage<AuxT>) + vegs::PAD_ALIGN * sizeof(float2) +
         static_cast<size_t>(nwarps) * vegs::PAD_ALIGN;
}

template <typename AuxT, bool CULL>
__global__ void __launch_bounds__(MAX_THREADS)
blend_fwd_kernel(const float* __restrict__ pf, const AuxT* __restrict__ pa,
                 const int* __restrict__ tile_starts, int64_t k, int ntx,
                 int tile_h, int tile_w, int hp, int wp, bool vec,
                 float* __restrict__ out, int* __restrict__ stop_out,
                 unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* st = reinterpret_cast<vegs::Stage<AuxT>*>(smem);
  float2* s_box = reinterpret_cast<float2*>(st + 2);
  uint8_t* list = reinterpret_cast<uint8_t*>(s_box + vegs::PAD_ALIGN) +
                  (threadIdx.x >> 5) * vegs::PAD_ALIGN;

  const int tile = blockIdx.x;
  int lx, ly;
  vegs::thread_pixel(threadIdx.x, tile_h, tile_w, &lx, &ly);
  const int gx = (tile % ntx) * tile_w + lx;
  const int gy = (tile / ntx) * tile_h + ly;
  const float px = static_cast<float>(gx);
  const float py = static_cast<float>(gy);
  const vegs::WarpRect rect = vegs::warp_rect(gx, gy);
  const int lane = threadIdx.x & 31;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const bool vec_ok = vec && start % 8 == 0;

  float acc[N_ACCUM];
#pragma unroll
  for (int c = 0; c < N_ACCUM; ++c) acc[c] = 0.0f;
  float logT = 0.0f;
  int done = 0;
  int stop = end - start;
  unsigned considered = 0, walked = 0;  // this warp's, < 2^32

  int buf = 0;
  if (start < end) {
    vegs::stage_batch(&st[0], pf, pa, k, start, min(vegs::PAD_ALIGN, end - start),
                      vec_ok);
    if (vec_ok) vegs::cp_async_wait_all();
    __syncthreads();
    vegs::stage_boxes<CULL>(st[0], s_box, min(vegs::PAD_ALIGN, end - start));
  }
  for (int b0 = start; b0 < end; b0 += vegs::PAD_ALIGN, buf ^= 1) {
    const int nb = min(vegs::PAD_ALIGN, end - b0);
    // the batch has landed and its boxes are written; the other buffer's
    // last readers (the previous batch) are done
    __syncthreads();
    const int b1 = b0 + vegs::PAD_ALIGN;
    if (b1 < end)
      vegs::stage_batch(&st[buf ^ 1], pf, pa, k, b1,
                        min(vegs::PAD_ALIGN, end - b1), vec_ok);
    const vegs::Stage<AuxT>& s = st[buf];
    if (!__all_sync(vegs::FULL_MASK, done)) {
      int cnt = 0;
      for (int c0 = 0; c0 < nb; c0 += 32) {
        const int j = c0 + lane;
        bool hit = j < nb;
        if constexpr (CULL)
          hit = hit && vegs::box_hits(rect.x0, rect.x1, rect.y0, rect.y1,
                                      s.f[0][j], s.f[1][j], s_box[j]);
        const unsigned m = __ballot_sync(vegs::FULL_MASK, hit);
        if (hit) list[cnt + __popc(m & ((1u << lane) - 1u))] = j;
        cnt += __popc(m);
      }
      __syncwarp();
      considered += nb;
      walked += cnt;
      if (!done) {
        for (int i = 0; i < cnt; ++i) {
          const int j = list[i];
          const float alpha = vegs::splat_alpha(px, py, s.f[0][j], s.f[1][j],
                                                s.f[2][j], s.f[3][j],
                                                s.f[4][j], s.f[5][j]);
          if (alpha == 0.0f) continue;
          const float T = vegs::transmittance(logT);
          if (vegs::crosses(T, alpha, vegs::T_EPS)) {
            done = 1;
            stop = b0 - start + j;  // the position in the range
            break;
          }
          const float w = __fmul_rn(alpha, T);
          acc[0] = __fmaf_rn(to_f32(s.a[0][j]), w, acc[0]);  // rgb
          acc[1] = __fmaf_rn(to_f32(s.a[1][j]), w, acc[1]);
          acc[2] = __fmaf_rn(to_f32(s.a[2][j]), w, acc[2]);
          acc[3] = __fmaf_rn(s.f[6][j], w, acc[3]);           // depth
#pragma unroll
          for (int c = 3; c < vegs::AUX_USED; ++c)
            acc[c + 1] = __fmaf_rn(to_f32(s.a[c][j]), w, acc[c + 1]);
          logT = vegs::next_logT(logT, alpha);
        }
      }
    }
    // the next batch's copies are this thread's; the barrier makes all of
    // them visible and ends every read of this batch and its boxes
    if (vec_ok) vegs::cp_async_wait_all();
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    if (b1 < end)
      vegs::stage_boxes<CULL>(st[buf ^ 1], s_box,
                              min(vegs::PAD_ALIGN, end - b1));
  }

  const size_t plane = static_cast<size_t>(hp) * wp;
  const size_t pix = static_cast<size_t>(gy) * wp + gx;
#pragma unroll
  for (int c = 0; c < N_ACCUM; ++c) out[c * plane + pix] = acc[c];
  out[N_ACCUM * plane + pix] = expf(logT);
  if (stop_out != nullptr) stop_out[pix] = stop;
  if (stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(considered));
    atomicAdd(&stats[1], static_cast<unsigned long long>(walked));
  }
}

template <typename AuxT, bool CULL>
int launch(const float* pf, const void* pa, const int* tile_starts,
           int64_t k, int ntx, int nty, int tile_h, int tile_w, float* out,
           int* stop_out, unsigned long long* stats, void* stream) {
  const int threads = tile_h * tile_w;
  const size_t smem = smem_bytes<AuxT>(threads / 32);
  auto kern = blend_fwd_kernel<AuxT, CULL>;
  const cudaError_t e = vegs::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = reinterpret_cast<uintptr_t>(pf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pa) % 16 == 0;
  kern<<<ntx * nty, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      pf, static_cast<const AuxT*>(pa), tile_starts, k, ntx, tile_h, tile_w,
      nty * tile_h, ntx * tile_w, vec, out, stop_out, stats);
  return static_cast<int>(cudaGetLastError());
}

template <bool CULL>
int dispatch(const float* pf, const void* pa, int aux_bf16,
             const int* tile_starts, int64_t k, int ntx, int nty, int tile_h,
             int tile_w, float* out, int* stop_out,
             unsigned long long* stats, void* stream) {
  if (aux_bf16)
    return launch<__nv_bfloat16, CULL>(pf, pa, tile_starts, k, ntx, nty,
                                       tile_h, tile_w, out, stop_out, stats,
                                       stream);
  return launch<float, CULL>(pf, pa, tile_starts, k, ntx, nty, tile_h, tile_w,
                             out, stop_out, stats, stream);
}

template <typename AuxT>
int info(int threads, int* res) {
  return vegs::kernel_info(blend_fwd_kernel<AuxT, true>, threads,
                           smem_bytes<AuxT>(threads / 32), res);
}

}  // namespace

// The main path's entry: the cull always on. `stats`, when not null,
// receives two counts summed over warps: the warp-instance pairs the warps
// considered (batches in which some pixel of the warp had not stopped) and
// the pairs they walked.
extern "C" int vegs_blend_fwd(const float* pf, const void* pa, int aux_bf16,
                              const int* tile_starts, int64_t k, int ntx,
                              int nty, int tile_h, int tile_w, float* out,
                              int* stop_out, unsigned long long* stats,
                              void* stream) {
  return dispatch<true>(pf, pa, aux_bf16, tile_starts, k, ntx, nty, tile_h,
                        tile_w, out, stop_out, stats, stream);
}

// The same kernel with the cull compiled out: for chip_smoke.py's
// bit-identity check and timing only.
extern "C" int vegs_blend_fwd_nocull(const float* pf, const void* pa,
                                     int aux_bf16, const int* tile_starts,
                                     int64_t k, int ntx, int nty, int tile_h,
                                     int tile_w, float* out, int* stop_out,
                                     unsigned long long* stats,
                                     void* stream) {
  return dispatch<false>(pf, pa, aux_bf16, tile_starts, k, ntx, nty, tile_h,
                         tile_w, out, stop_out, stats, stream);
}

// Registers per thread, shared memory per block (bytes), resident blocks
// per SM and local (spill) bytes per thread of the main path's kernel for
// tiles of `threads` pixels, into res[0..3].
extern "C" int vegs_blend_fwd_info(int aux_bf16, int threads, int* res) {
  return aux_bf16 ? info<__nv_bfloat16>(threads, res)
                  : info<float>(threads, res);
}
