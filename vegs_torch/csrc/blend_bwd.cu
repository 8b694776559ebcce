// K2: tile blend backward for Hopper.
//
// Replaces the Pallas kernel vegs_tpu/ops/blend_pallas.py:_bwd_kernel (274),
// launched by _blend_bwd_impl (502) through the blend's custom VJP
// (567-583). Given the forward output `out` [12, hp, wp] and its cotangent
// `dout`, it writes each instance's gradient: dpf [8, K] (mean x/y, conic
// a/b/c, opacity, depth, 0) in f32 and dpa [16, K] (rgb, quat, scale, 0 x6)
// in the aux dtype (bf16 rounded to nearest even, or f32).
//
// One forward-walking sweep, as in the Pallas kernel: each pixel is seeded
// with tail = sum_c dout_c * out_c over the 12 channels (the suffix total of
// w_i * dw_i plus T_final * dT_final), then walks its tile's instances front
// to back with K1's walk (csrc/splat.cuh, the same log-T carry, the same
// stop), so an instance the forward excluded gets exactly zero and none it
// included is skipped. Per included pair: w = alpha T, dw = dout . chan,
// cum += w dw, dL = tail - cum, dalpha = T dw - dL / (1 - alpha),
// dpower = dalpha alpha and dop = dalpha exp(power) where alpha_raw < 0.99.
// The mean and conic gradients are formed per pixel by the chain rule
// (dmean = dpower (C d), dconic = -dpower d d^T / 2 off-diagonal doubled,
// with d = p - mean), so each instance reduces 17 values that go straight
// to their rows. tail and cum are carried with their rounding errors
// (compensated dot products): for the deep, low-T instances dL = tail - cum
// cancels, and a plain float32 running sum left their gradients further
// from a float64 walk than the float32 plain version (PERF.md).
//
// Bound on this card: like K1, scalar fp32 math per (pixel, instance) pair
// up to each pixel's stop, plus a 17-value reduction over the tile's
// pixels for every instance; the bytes (the payload rows once per tile, out
// and dout once, the gradients once) are far below. The operations bound
// it, and the first design spent most of them where nothing was computed:
// every pixel evaluated every instance of its range (~91% at alpha 0), and
// each instance any lane of a warp included cost 18 five-level shuffle
// trees (90 shuffles and adds, against ~30 operations of gradient math),
// three block barriers per 32 instances and a serial 8-warp sum.
//
// Design: one block per tile, one thread per pixel, each warp on a compact
// 8x4 rectangle (splat.cuh: thread_pixel). The block's warp count NW is a
// template parameter, the least build that holds the tile: 8 warps for
// tiles of up to 256 pixels (16x16), 16 for 512 (16x32, 32x16), 32 for
// 1024 (32x32). What bounds each build (per SM: 65,536 registers, 228 KB
// of shared memory; a block may take 227 KB):
//   NW = 8:  three blocks per SM (MIN_BLOCKS; 61.5 KB of shared memory
//            each with bf16 aux, s_red 34.8 KB), at most 85 registers a
//            thread (it takes 71);
//   NW = 16: two blocks per SM, so at most 64 registers a thread (2 x 512
//            x 64 = 65,536); s_red 69.6 KB, 96.4 KB a block with bf16 aux
//            (106.6 KB with f32), two of them fit;
//   NW = 32: one block per SM, at most 64 registers a thread (1,024
//            threads at the 16x16 build's 71 would need 72,704): the
//            compiler spills what does not fit. s_red is 139.3 KB, 166.1
//            KB a block with bf16 aux (176.4 KB with f32).
// So a wide tile keeps its pixels in one block and every instance's sum
// over the tile stays the in-block warp-ordered sum below: no sum crosses
// blocks, no atomics, and the result does not change from run to run at
// any tile shape.
// 256-instance batches are staged in shared memory with cp.async, the next
// one while the current one is walked, with each instance's footprint box
// computed once per batch (splat.cuh). Per 32-instance sub-batch a warp
// tests the 32 instances against its rectangle, one per lane, and walks
// only the hits, in range order, from its ballot word: a skipped instance
// has alpha 0 at every pixel of the warp, so it would contribute v = 0 and
// no inclusion, and no state changes. For an instance some lane includes,
// the warp sums its 32 pixels' 17 values by recursive halving -- at each of
// 5 levels a lane keeps half of its values and sends the other half to its
// partner (20 shuffles) -- and the lane left holding value r writes
// s_red[warp][r][jj]; the warp also records which instances it wrote.
// After one barrier per sub-batch, the warps take the 17 rows in turn, add
// the warps' sums in warp order (entries a warp did not write read 0) and
// write each instance's slot once; s_red is double-buffered, so the next
// sub-batch's walk needs no second barrier. (A 64-instance sub-batch halves
// the barriers but leaves room for two blocks per SM only, and measured
// slower.) No atomics on the gradients: the result does not change from
// run to run. Slots after the block's early exit, and past
// tile_starts[-1], keep the zeros the wrapper allocated. The cull is a
// template parameter: the C entry vegs_blend_bwd always runs it, and
// vegs_blend_bwd_nocull, with the cull compiled out, exists only for the
// bit-identity check and timing in chip_smoke.py. The TPU devices
// (triangular-matmul prefix sums, 8-tile programs, 256-slot DMA
// superchunks) are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "splat.cuh"

namespace {

constexpr int N_ACCUM = 11;   // output channel 11 is the final T
constexpr int N_RED = 17;     // reduced per instance: dmean x/y, dconic
                              // a/b/c, dop, the 11 channels
constexpr int SUB = 32;       // instances per reduction sub-batch
constexpr int NCH = SUB / 32;
// Resident blocks per SM each build must allow (see the design note): the
// 16x16 build's three; two and one for the wide builds, which caps their
// registers at 64 a thread.
constexpr int min_blocks(int nw) { return nw <= 8 ? 3 : (nw <= 16 ? 2 : 1); }

// Calls f(std::integral_constant<int, NW>{}) with the least build NW that
// holds a tile of `threads` pixels (see the design note); a tile no build
// takes is refused.
template <typename F>
int with_warps(int threads, F f) {
  if (threads <= 0 || threads % 32 != 0 || threads > 32 * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads <= 8 * 32) return f(std::integral_constant<int, 8>{});
  if (threads <= 16 * 32) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

// The output row of each reduced value: dpf row r as r, dpa row r as -1-r.
// Values 6-16 are the channels rgb, depth, quat wxyz, scale.
__constant__ const int OUT_ROW[N_RED] = {0,  1,  2,  3,  4,  5,  -1, -2, -3,
                                         6,  -4, -5, -6, -7, -8, -9, -10};

using vegs::to_f32;

__device__ __forceinline__ void put(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename AuxT, int NW>
struct Shared {
  vegs::Stage<AuxT> st[2];
  float2 box[vegs::PAD_ALIGN];
  float red[2][NW][N_RED][SUB];
  unsigned wrote[2][NW][NCH];  // per warp: the entries it wrote
};

// *s + *e += x * y, compensated: the product's rounding error (an FMA) and
// the sum's (TwoSum) go into *e, so s + e carries the sum to about twice
// float32's precision (Ogita, Rump and Oishi's Dot2).
__device__ __forceinline__ void dot2_add(float x, float y, float* s,
                                         float* e) {
  const float p = __fmul_rn(x, y);
  const float pe = __fmaf_rn(x, y, -p);
  const float t = __fadd_rn(*s, p);
  const float bp = __fsub_rn(t, *s);
  const float te = __fadd_rn(__fsub_rn(*s, __fsub_rn(t, bp)), __fsub_rn(p, bp));
  *e = __fadd_rn(*e, __fadd_rn(te, pe));
  *s = t;
}

// One level of the recursive-halving sum: N values per lane (padded with
// zeros to even), the lane whose `off` bit is set keeps the upper half and
// sends the lower one, its partner the reverse.
template <int N>
__device__ __forceinline__ void halve(float* v, int off, bool upper) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = (i + H < N) ? v[i + H] : 0.0f;
    const float recv =
        __shfl_xor_sync(vegs::FULL_MASK, upper ? lo : hi, off);
    v[i] = __fadd_rn(upper ? hi : lo, recv);
  }
}

// The warp's sums of the N_RED = 17 values (levels of 17, 9, 5, 3, 2
// values: 20 shuffles); lane `lane` is left holding the sum of value
// red_row(lane) in v[0].
__device__ __forceinline__ void warp_sum(float* v, int lane) {
  halve<N_RED>(v, 16, lane & 16);
  halve<(N_RED + 1) / 2>(v, 8, lane & 8);
  halve<5>(v, 4, lane & 4);
  halve<3>(v, 2, lane & 2);
  halve<2>(v, 1, lane & 1);
}

// Which of the values `warp_sum` leaves with this lane, or -1 (a lane
// left holding only padding).
__device__ __forceinline__ int red_row(int lane) {
  int n = N_RED, pad = N_RED, base = 0;
  for (int off = 16; off > 0; off >>= 1) {
    const int h = (pad + 1) / 2;
    if (lane & off) {
      base += h;
      n = max(n - h, 0);
    } else {
      n = min(n, h);
    }
    pad = h;
  }
  return n > 0 ? base : -1;
}

template <typename AuxT, bool CULL, int NW>
__global__ void __launch_bounds__(NW * 32, min_blocks(NW))
blend_bwd_kernel(const float* __restrict__ pf, const AuxT* __restrict__ pa,
                 const int* __restrict__ tile_starts, int64_t k, int ntx,
                 int tile_h, int tile_w, int hp, int wp, bool vec,
                 const float* __restrict__ out, const float* __restrict__ dout,
                 float* __restrict__ dpf, AuxT* __restrict__ dpa,
                 unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<AuxT, NW>& sh = *reinterpret_cast<Shared<AuxT, NW>*>(smem);

  const int tile = blockIdx.x;
  int lx, ly;
  vegs::thread_pixel(threadIdx.x, tile_h, tile_w, &lx, &ly);
  const int gx = (tile % ntx) * tile_w + lx;
  const int gy = (tile / ntx) * tile_h + ly;
  const float px = static_cast<float>(gx);
  const float py = static_cast<float>(gy);
  const vegs::WarpRect rect = vegs::warp_rect(gx, gy);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int my_row = red_row(lane);
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const bool vec_ok = vec && start % 8 == 0;

  const size_t plane = static_cast<size_t>(hp) * wp;
  const size_t pix = static_cast<size_t>(gy) * wp + gx;
  float dacc[N_ACCUM];
  // tail = sum_c dout_c out_c and cum = sum of w dw so far, each carried
  // with its rounding error (tail_e, cum_e): dL = tail - cum cancels for the
  // deep, low-T instances, and the compensated sums keep what is left
  float tail = 0.0f, tail_e = 0.0f;
#pragma unroll
  for (int c = 0; c <= N_ACCUM; ++c) {
    const float d = dout[c * plane + pix];
    if (c < N_ACCUM) dacc[c] = d;
    dot2_add(d, out[c * plane + pix], &tail, &tail_e);
  }

  float logT = 0.0f;
  float cum = 0.0f, cum_e = 0.0f;
  int done = 0;
  int sb = 0;  // the s_red buffer of the current sub-batch
  unsigned considered = 0, walked = 0;  // this warp's, < 2^32

  int buf = 0;
  if (start < end) {
    vegs::stage_batch(&sh.st[0], pf, pa, k, start,
                      min(vegs::PAD_ALIGN, end - start), vec_ok);
    if (vec_ok) vegs::cp_async_wait_all();
    __syncthreads();
    vegs::stage_boxes<CULL>(sh.st[0], sh.box,
                            min(vegs::PAD_ALIGN, end - start));
  }
  for (int b0 = start; b0 < end; b0 += vegs::PAD_ALIGN, buf ^= 1) {
    const int nb = min(vegs::PAD_ALIGN, end - b0);
    // the batch has landed and its boxes are written; the other buffer's
    // last readers (the previous batch) are done
    __syncthreads();
    const int b1 = b0 + vegs::PAD_ALIGN;
    if (b1 < end)
      vegs::stage_batch(&sh.st[buf ^ 1], pf, pa, k, b1,
                        min(vegs::PAD_ALIGN, end - b1), vec_ok);
    const vegs::Stage<AuxT>& s = sh.st[buf];
    for (int s0 = 0; s0 < nb; s0 += SUB, sb ^= 1) {
      const int ns = min(SUB, nb - s0);
      const bool skip = __all_sync(vegs::FULL_MASK, done);
      considered += skip ? 0 : ns;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int c0 = s0 + ch * 32;
        bool hit = !skip && ch * 32 + lane < ns;
        if constexpr (CULL)
          hit = hit && vegs::box_hits(rect.x0, rect.x1, rect.y0, rect.y1,
                                      s.f[0][c0 + lane], s.f[1][c0 + lane],
                                      sh.box[c0 + lane]);
        unsigned todo = __ballot_sync(vegs::FULL_MASK, hit);
        unsigned wrote = 0;
        walked += __popc(todo);
        while (todo) {
          const int jj = __ffs(todo) - 1;
          todo &= todo - 1;
          const int j = c0 + jj;
          float v[N_RED];
#pragma unroll
          for (int r = 0; r < N_RED; ++r) v[r] = 0.0f;
          bool inc = false;
          if (!done) {
            float expp, alpha_raw;
            const float mx = s.f[0][j], my = s.f[1][j];
            const float a = s.f[2][j], b = s.f[3][j], c = s.f[4][j];
            const float alpha = vegs::splat_eval(px, py, mx, my, a, b, c,
                                                 s.f[5][j], &expp, &alpha_raw);
            if (alpha != 0.0f) {
              const float T = vegs::transmittance(logT);
              if (vegs::crosses(T, alpha, vegs::T_EPS)) {
                done = 1;
              } else {
                inc = true;
                const float chan[N_ACCUM] = {
                    to_f32(s.a[0][j]), to_f32(s.a[1][j]), to_f32(s.a[2][j]),
                    s.f[6][j],         to_f32(s.a[3][j]), to_f32(s.a[4][j]),
                    to_f32(s.a[5][j]), to_f32(s.a[6][j]), to_f32(s.a[7][j]),
                    to_f32(s.a[8][j]), to_f32(s.a[9][j])};
                const float w = __fmul_rn(alpha, T);
                float dw = 0.0f;
#pragma unroll
                for (int q = 0; q < N_ACCUM; ++q)
                  dw = __fmaf_rn(dacc[q], chan[q], dw);
                dot2_add(w, dw, &cum, &cum_e);
                const float dL =
                    __fadd_rn(__fsub_rn(tail, cum), __fsub_rn(tail_e, cum_e));
                const float dalpha =
                    __fsub_rn(__fmul_rn(T, dw),
                              __fdiv_rn(dL, __fsub_rn(1.0f, alpha)));
                if (alpha_raw < vegs::ALPHA_CLAMP) {
                  // d power / d (mean, conic), per pixel
                  const float dpower = __fmul_rn(dalpha, alpha);
                  const float dx = __fsub_rn(px, mx);
                  const float dy = __fsub_rn(py, my);
                  const float hx = __fmul_rn(-0.5f, __fmul_rn(dpower, dx));
                  const float hy = __fmul_rn(-0.5f, __fmul_rn(dpower, dy));
                  v[0] = __fmul_rn(dpower, __fmaf_rn(a, dx, __fmul_rn(b, dy)));
                  v[1] = __fmul_rn(dpower, __fmaf_rn(b, dx, __fmul_rn(c, dy)));
                  v[2] = __fmul_rn(hx, dx);
                  v[3] = __fmul_rn(__fmul_rn(-dpower, dx), dy);
                  v[4] = __fmul_rn(hy, dy);
                  v[5] = __fmul_rn(dalpha, expp);
                }
#pragma unroll
                for (int q = 0; q < N_ACCUM; ++q)
                  v[6 + q] = __fmul_rn(dacc[q], w);
                logT = vegs::next_logT(logT, alpha);
              }
            }
          }
          if (__any_sync(vegs::FULL_MASK, inc)) {
            warp_sum(v, lane);
            if (my_row >= 0) sh.red[sb][warp][my_row][ch * 32 + jj] = v[0];
            wrote |= 1u << jj;
          }
        }
        if (lane == 0) sh.wrote[sb][warp][ch] = wrote;
      }
      // this sub-batch's warp sums are written; the reads of the buffer's
      // previous use (two sub-batches back) ended before the last barrier
      __syncthreads();
      // the warps' sums in warp order, one gradient row per task
      for (int r = warp; r < N_RED; r += nwarps) {
        const int row = OUT_ROW[r];
        for (int jj = lane; jj < ns; jj += 32) {
          float t = 0.0f;
          for (int wi = 0; wi < nwarps; ++wi)
            if ((sh.wrote[sb][wi][jj >> 5] >> (jj & 31)) & 1u)
              t = __fadd_rn(t, sh.red[sb][wi][r][jj]);
          const size_t g = static_cast<size_t>(b0 + s0 + jj);
          if (row < 0)
            put(dpa, (-1 - row) * k + g, t);
          else
            dpf[row * k + g] = t;
        }
      }
    }
    // the next batch's copies are this thread's; the barrier makes all of
    // them visible and ends every read of this batch and its boxes
    if (vec_ok) vegs::cp_async_wait_all();
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    if (b1 < end)
      vegs::stage_boxes<CULL>(sh.st[buf ^ 1], sh.box,
                              min(vegs::PAD_ALIGN, end - b1));
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(considered));
    atomicAdd(&stats[1], static_cast<unsigned long long>(walked));
  }
}

template <typename AuxT, bool CULL, int NW>
int launch(const float* pf, const void* pa, const int* tile_starts,
           int64_t k, int ntx, int nty, int tile_h, int tile_w,
           const float* out, const float* dout, float* dpf, void* dpa,
           unsigned long long* stats, void* stream) {
  constexpr size_t smem = sizeof(Shared<AuxT, NW>);
  auto kern = blend_bwd_kernel<AuxT, CULL, NW>;
  const cudaError_t e = vegs::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = reinterpret_cast<uintptr_t>(pf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pa) % 16 == 0;
  kern<<<ntx * nty, tile_h * tile_w, smem,
         static_cast<cudaStream_t>(stream)>>>(
      pf, static_cast<const AuxT*>(pa), tile_starts, k, ntx, tile_h, tile_w,
      nty * tile_h, ntx * tile_w, vec, out, dout, dpf,
      static_cast<AuxT*>(dpa), stats);
  return static_cast<int>(cudaGetLastError());
}

template <bool CULL>
int dispatch(const float* pf, const void* pa, int aux_bf16,
             const int* tile_starts, int64_t k, int ntx, int nty, int tile_h,
             int tile_w, const float* out, const float* dout, float* dpf,
             void* dpa, unsigned long long* stats, void* stream) {
  return with_warps(tile_h * tile_w, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    if (aux_bf16)
      return launch<__nv_bfloat16, CULL, NW>(pf, pa, tile_starts, k, ntx, nty,
                                             tile_h, tile_w, out, dout, dpf,
                                             dpa, stats, stream);
    return launch<float, CULL, NW>(pf, pa, tile_starts, k, ntx, nty, tile_h,
                                   tile_w, out, dout, dpf, dpa, stats, stream);
  });
}

// The build a tile of `threads` pixels launches (see with_warps).
template <typename AuxT>
int info(int threads, int* res) {
  return with_warps(threads, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    return vegs::kernel_info(blend_bwd_kernel<AuxT, true, NW>, threads,
                             sizeof(Shared<AuxT, NW>), res);
  });
}

}  // namespace

// The main path's entry: the cull always on. `stats`, when not null,
// receives two counts summed over warps: the warp-instance pairs the warps
// considered (sub-batches in which some pixel of the warp had not stopped)
// and the pairs they walked.
extern "C" int vegs_blend_bwd(const float* pf, const void* pa, int aux_bf16,
                              const int* tile_starts, int64_t k, int ntx,
                              int nty, int tile_h, int tile_w,
                              const float* out, const float* dout, float* dpf,
                              void* dpa, unsigned long long* stats,
                              void* stream) {
  return dispatch<true>(pf, pa, aux_bf16, tile_starts, k, ntx, nty, tile_h,
                        tile_w, out, dout, dpf, dpa, stats, stream);
}

// The same kernel with the cull compiled out: for chip_smoke.py's
// bit-identity check and timing only.
extern "C" int vegs_blend_bwd_nocull(const float* pf, const void* pa,
                                     int aux_bf16, const int* tile_starts,
                                     int64_t k, int ntx, int nty, int tile_h,
                                     int tile_w, const float* out,
                                     const float* dout, float* dpf, void* dpa,
                                     unsigned long long* stats,
                                     void* stream) {
  return dispatch<false>(pf, pa, aux_bf16, tile_starts, k, ntx, nty, tile_h,
                         tile_w, out, dout, dpf, dpa, stats, stream);
}

// Registers per thread, shared memory per block (bytes), resident blocks
// per SM and local (spill) bytes per thread of the main path's kernel for
// tiles of `threads` pixels (the build with_warps picks), into res[0..3].
extern "C" int vegs_blend_bwd_info(int aux_bf16, int threads, int* res) {
  return aux_bf16 ? info<__nv_bfloat16>(threads, res)
                  : info<float>(threads, res);
}
