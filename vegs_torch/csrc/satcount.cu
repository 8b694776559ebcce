// K4: saturation count for Hopper.
//
// Replaces the Pallas kernel vegs_tpu/ops/satcull.py:_satcount_kernel (65),
// launched by satcount (171). For each tile of the (tile, depth)-sorted RAW
// instance stream it counts the leading instances that can still contribute
// to some pixel: it replays the blend's per-pixel walk with the crossing
// threshold tightened to T_EPS * 0.5 and stops at the 256-slot window in
// which the last pixel of the tile crosses. The count is rounded up to that
// window (kept = clip(w0 + windows * 256 - start, 0, end - start)); the
// window granularity is part of the output contract.
//
// Bound on this card: like the blend forward, scalar fp32 math per
// (pixel, instance) pair up to each tile's exit; it reads 28 B per raw slot
// up to each tile's exit (the sorted Gaussian index and rows 0-5 of that
// Gaussian's payload row). The operations bound it -- and ~91% of the pairs
// have alpha 0.
//
// Design: one block per tile, one thread per pixel, each warp on a compact
// 8x4 rectangle of the tile (splat.cuh: thread_pixel), the same splat math
// as K1 (splat.cuh). The tile's range is walked in 256-slot windows from
// w0 = floor(start / 256) * 256. Each window is fetched where it lies: on
// the main path (`vegs_satcount`) a thread per slot reads the slot's
// Gaussian index and copies that Gaussian's 32-byte payload row ([n+1, 8]
// f32, row-major) into shared memory with two 16-byte cp.async; the JAX
// layout (`vegs_satcount_cm`, [8, k] channel-major rows in sorted order)
// copies rows 0-5 of the slot with 4-byte cp.async. The fetch is a template
// policy of one kernel body. Windows are double-buffered: the next one is
// in flight while the current one is walked. The thread that fetched a slot
// also computes its conservative footprint box (splat.cuh: footprint_box)
// once it has its own copies, so one barrier per window makes both the
// rows and the boxes visible. Each warp then packs, in range order, the
// in-range slots whose box reaches its rectangle into a warp-private list
// (__ballot_sync / __popc) and walks only that list carrying log T: a
// skipped instance has alpha 0 at all 32 of the warp's pixels, which the
// walk skips too, so log T, every crossing and the count do not change. A
// warp whose pixels have all crossed skips the rest of the window; the
// block leaves after the window in which every pixel has crossed
// (__syncthreads_count). K1 then walks exactly the same instances from the
// same start, so a render with the saturation cull on is bit-identical to
// one with it off. The cull is a template parameter, as in K1:
// `vegs_satcount_nocull` compiles it out, for chip_smoke.py's bit-identity
// check and timing only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int PAD = vegs::PAD_ALIGN;
constexpr float SAFETY = 0.5f;
// Floats per staged slot: the payload row's 8 (6 used), padded to 48 bytes
// so that the eight lanes of a quarter-warp reading 16 bytes each of
// neighbouring slots hit eight distinct bank groups (at 32 bytes, two).
constexpr int SLOT_FLOATS = 12;

struct Window {
  float row[PAD][SLOT_FLOATS];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// The main path's fetch: slot g's Gaussian row of the padded [n1, 8] f32
// payload, through the sorted Gaussian index. Indices of slots outside
// every range may point anywhere in [0, n1); they are clamped all the same.
struct GatheredRows {
  const float* pay;
  const int* gidx;
  int n1;
  __device__ __forceinline__ void fetch(float* dst, int g) const {
    const int gi = min(max(gidx[g], 0), n1 - 1);
    const float* src = pay + static_cast<size_t>(gi) * 8;
    vegs::cp_async16(dst, src);
    vegs::cp_async16(dst + 4, src + 4);
  }
};

// The JAX layout's fetch: rows 0-5 of slot g of the channel-major [>= 6, k]
// f32 rows in sorted order.
struct ChannelMajor {
  const float* pf;
  int64_t k;
  __device__ __forceinline__ void fetch(float* dst, int g) const {
#pragma unroll
    for (int r = 0; r < 6; ++r) cp_async4(dst + r, pf + r * k + g);
  }
};

// Dynamic shared memory: two windows, their boxes (mx, my, rx, ry), one
// 256-entry index list per warp.
size_t smem_bytes(int nwarps) {
  return 2 * sizeof(Window) + 2 * PAD * sizeof(float4) +
         static_cast<size_t>(nwarps) * PAD;
}

template <class Fetch, bool CULL>
__global__ void __launch_bounds__(MAX_THREADS)
satcount_kernel(Fetch fetch, const int* __restrict__ starts, int ntx,
                int tile_h, int tile_w, int* __restrict__ out,
                unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  Window* win = reinterpret_cast<Window*>(smem);
  float4* cbox = reinterpret_cast<float4*>(win + 2);
  uint8_t* list = reinterpret_cast<uint8_t*>(cbox + 2 * PAD) +
                  (threadIdx.x >> 5) * PAD;

  const int tile = blockIdx.x;
  int lx, ly;
  vegs::thread_pixel(threadIdx.x, tile_h, tile_w, &lx, &ly);
  const int gx = (tile % ntx) * tile_w + lx;
  const int gy = (tile / ntx) * tile_h + ly;
  const float px = static_cast<float>(gx);
  const float py = static_cast<float>(gy);
  const vegs::WarpRect rect = vegs::warp_rect(gx, gy);
  const int lane = threadIdx.x & 31;
  const int start = starts[tile];
  const int end = starts[tile + 1];
  const int w0 = (start / PAD) * PAD;
  // an empty range counts 0 whatever is walked: walk nothing
  const int nsc = end > start ? (end - w0 + PAD - 1) / PAD : 0;
  const float eps = vegs::T_EPS * SAFETY;

  // Fetch window [g0, g0 + 256) into buffer b, each thread its own slots.
  // g0 < end <= k and k is a multiple of 256, so the window lies inside
  // the arrays.
  auto stage = [&](int b, int g0) {
    for (int j = threadIdx.x; j < PAD; j += blockDim.x)
      fetch.fetch(win[b].row[j], g0 + j);
    vegs::cp_async_commit();
  };
  // After the caller's own copies have landed: the boxes of its slots.
  auto boxes = [&](int b) {
    if constexpr (CULL) {
      for (int j = threadIdx.x; j < PAD; j += blockDim.x) {
        const float* r = win[b].row[j];
        const float4 v = *reinterpret_cast<const float4*>(r);
        const float2 w = *reinterpret_cast<const float2*>(r + 4);
        const float2 box = vegs::footprint_box(v.x, v.y, v.z, v.w, w.x, w.y);
        cbox[b * PAD + j] = make_float4(v.x, v.y, box.x, box.y);
      }
    }
  };

  float logT = 0.0f;
  int crossed = 0;
  int sc_exit = nsc;
  unsigned considered = 0, walked = 0;  // this warp's, < 2^32
  if (nsc > 0) {
    stage(0, w0);
    vegs::cp_async_wait_all();
    boxes(0);
    __syncthreads();
  }
  for (int sc = 0; sc < nsc; ++sc) {
    // window sc and its boxes are visible; the other buffer's last readers
    // (window sc - 1) passed the barrier that ended the previous iteration
    const int b = sc & 1;
    const int g0 = w0 + sc * PAD;
    const bool more = sc + 1 < nsc;
    if (more) stage(b ^ 1, g0 + PAD);
    if (!__all_sync(vegs::FULL_MASK, crossed)) {
      const int lo = max(start - g0, 0), hi = min(end - g0, PAD);
      int cnt = 0;
      for (int c0 = lo & ~31; c0 < hi; c0 += 32) {
        const int j = c0 + lane;
        bool hit = j >= lo && j < hi;
        if constexpr (CULL) {
          if (hit) {
            const float4 cb = cbox[b * PAD + j];
            hit = vegs::box_hits(rect.x0, rect.x1, rect.y0, rect.y1, cb.x,
                                 cb.y, make_float2(cb.z, cb.w));
          }
        }
        const unsigned m = __ballot_sync(vegs::FULL_MASK, hit);
        if (hit) list[cnt + __popc(m & ((1u << lane) - 1u))] = j;
        cnt += __popc(m);
      }
      __syncwarp();
      considered += hi - lo;
      walked += cnt;
      if (!crossed) {
        for (int i = 0; i < cnt; ++i) {
          const float* r = win[b].row[list[i]];
          const float4 v = *reinterpret_cast<const float4*>(r);
          const float2 w = *reinterpret_cast<const float2*>(r + 4);
          const float alpha =
              vegs::splat_alpha(px, py, v.x, v.y, v.z, v.w, w.x, w.y);
          if (alpha == 0.0f) continue;
          if (vegs::crosses(vegs::transmittance(logT), alpha, eps)) {
            crossed = 1;
            break;
          }
          logT = vegs::next_logT(logT, alpha);
        }
      }
    }
    if (more) {
      vegs::cp_async_wait_all();
      boxes(b ^ 1);
    }
    // makes the next window's rows and boxes visible and ends every read of
    // this window's
    if (__syncthreads_count(crossed) == static_cast<int>(blockDim.x)) {
      sc_exit = sc + 1;
      break;
    }
  }
  if (threadIdx.x == 0) {
    const int kept = w0 + sc_exit * PAD - start;
    out[tile] = min(max(kept, 0), end - start);
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(considered));
    atomicAdd(&stats[1], static_cast<unsigned long long>(walked));
  }
}

template <class Fetch, bool CULL>
int launch(Fetch fetch, const int* raw_starts, int ntx, int nty, int tile_h,
           int tile_w, int* out, unsigned long long* stats, void* stream) {
  const int threads = tile_h * tile_w;
  const size_t smem = smem_bytes(threads / 32);
  auto kern = satcount_kernel<Fetch, CULL>;
  const cudaError_t e = vegs::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<ntx * nty, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      fetch, raw_starts, ntx, tile_h, tile_w, out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The main path's entry, the cull on: pay [n1, 8] f32 row-major (16-byte
// aligned), gidx [k] int32 (k a multiple of 256), raw_starts [T + 1].
// `stats`, when not null, receives two counts summed over warps: the
// warp-instance pairs the warps considered (in-range slots of windows in
// which some pixel of the warp had not crossed) and the pairs they walked.
extern "C" int vegs_satcount(const float* pay, int n1, const int* gidx,
                             const int* raw_starts, int ntx, int nty,
                             int tile_h, int tile_w, int* out,
                             unsigned long long* stats, void* stream) {
  return launch<GatheredRows, true>(GatheredRows{pay, gidx, n1}, raw_starts,
                                    ntx, nty, tile_h, tile_w, out, stats,
                                    stream);
}

// The same with the cull compiled out: for chip_smoke.py's bit-identity
// check and timing only.
extern "C" int vegs_satcount_nocull(const float* pay, int n1, const int* gidx,
                                    const int* raw_starts, int ntx, int nty,
                                    int tile_h, int tile_w, int* out,
                                    unsigned long long* stats, void* stream) {
  return launch<GatheredRows, false>(GatheredRows{pay, gidx, n1}, raw_starts,
                                     ntx, nty, tile_h, tile_w, out, stats,
                                     stream);
}

// The JAX package's contract: pf [>= 6, k] f32 channel-major rows in sorted
// order (k a multiple of 256), the cull on.
extern "C" int vegs_satcount_cm(const float* pf, int64_t k,
                                const int* raw_starts, int ntx, int nty,
                                int tile_h, int tile_w, int* out,
                                unsigned long long* stats, void* stream) {
  return launch<ChannelMajor, true>(ChannelMajor{pf, k}, raw_starts, ntx, nty,
                                    tile_h, tile_w, out, stats, stream);
}

// Registers per thread, shared memory per block (bytes), resident blocks
// per SM and local (spill) bytes per thread of the main path's kernel for
// tiles of `threads` pixels, into res[0..3].
extern "C" int vegs_satcount_info(int threads, int* res) {
  return vegs::kernel_info(satcount_kernel<GatheredRows, true>, threads,
                           smem_bytes(threads / 32), res);
}
