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
// dpower = dalpha alpha and dop = dalpha exp(power) where alpha_raw < 0.99;
// the conic and mean gradients come from dpower times the six tile-local
// pixel monomials (1, x, y, x^2, y^2, xy), as the Pallas kernel forms them.
//
// Bound on this card: like K1, scalar fp32 math per (pixel, instance) pair
// up to each pixel's stop, plus an 18-value reduction over the tile's
// pixels for every instance; the bytes (the payload rows once per tile, out
// and dout once, the gradients once) are far below. The operations bound it.
//
// Design: one block per 16x16 tile, one thread per pixel; 256-instance
// batches staged in shared memory as in K1. Each instance's gradient is a
// block reduction, written once to its own slot: no atomics, so the result
// does not change from run to run. A warp first sums its 32 pixels' 18
// values with shuffles (skipped when no pixel of the warp includes the
// instance), lane 0 parks the warp sums for 32 instances in shared memory,
// then 32 threads add the warps' sums in warp order and write the slots.
// Slots after the block's early exit, and past tile_starts[-1], keep the
// zeros the wrapper allocated. The TPU devices (triangular-matmul prefix
// sums, 8-tile programs, 256-slot DMA superchunks) are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splat.cuh"

namespace {

constexpr int F32_USED = 7;   // mx, my, conic a/b/c, opacity, depth
constexpr int AUX_USED = 10;  // rgb, quat wxyz, scale
constexpr int N_ACCUM = 11;   // output channel 11 is the final T
constexpr int N_RED = 18;     // reduced per instance: 6 monomials, dop, 11
constexpr int SUB = 32;       // instances per reduction sub-batch
constexpr int MAX_WARPS = 8;  // 256 pixels per tile
constexpr unsigned FULL = 0xffffffffu;

template <bool BF16>
__device__ __forceinline__ float aux_at(const void* pa, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(pa)[i]);
  } else {
    return static_cast<const float*>(pa)[i];
  }
}

template <bool BF16>
__device__ __forceinline__ void aux_put(void* pa, size_t i, float v) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(pa)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(pa)[i] = v;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(MAX_WARPS * 32)
blend_bwd_kernel(const float* __restrict__ pf, const void* __restrict__ pa,
                 const int* __restrict__ tile_starts, int64_t k, int ntx,
                 int tile_h, int tile_w, int hp, int wp,
                 const float* __restrict__ out, const float* __restrict__ dout,
                 float* __restrict__ dpf, void* __restrict__ dpa) {
  __shared__ float s_f[F32_USED][vegs::PAD_ALIGN];
  __shared__ float s_a[AUX_USED][vegs::PAD_ALIGN];
  __shared__ float s_red[MAX_WARPS][N_RED][SUB];

  const int tile = blockIdx.x;
  const int lx = threadIdx.x % tile_w;
  const int ly = threadIdx.x / tile_w;
  const int gx = (tile % ntx) * tile_w + lx;
  const int gy = (tile / ntx) * tile_h + ly;
  const float px = static_cast<float>(gx);
  const float py = static_cast<float>(gy);
  const float ox = static_cast<float>((tile % ntx) * tile_w);
  const float oy = static_cast<float>((tile / ntx) * tile_h);
  // tile-local pixel monomials (1, x, y, x^2, y^2, xy)
  const float xl = static_cast<float>(lx);
  const float yl = static_cast<float>(ly);
  const float mono[6] = {1.0f, xl, yl, xl * xl, yl * yl, xl * yl};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];

  const size_t plane = static_cast<size_t>(hp) * wp;
  const size_t pix = static_cast<size_t>(gy) * wp + gx;
  float dacc[N_ACCUM];
  float tail = 0.0f;
#pragma unroll
  for (int c = 0; c < N_ACCUM; ++c) {
    dacc[c] = dout[c * plane + pix];
    tail += dacc[c] * out[c * plane + pix];
  }
  tail += dout[N_ACCUM * plane + pix] * out[N_ACCUM * plane + pix];

  float logT = 0.0f;
  float cum = 0.0f;
  int done = 0;

  for (int b0 = start; b0 < end; b0 += vegs::PAD_ALIGN) {
    const int nb = min(vegs::PAD_ALIGN, end - b0);
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const size_t g = static_cast<size_t>(b0 + j);
#pragma unroll
      for (int r = 0; r < F32_USED; ++r) s_f[r][j] = pf[r * k + g];
#pragma unroll
      for (int r = 0; r < AUX_USED; ++r) s_a[r][j] = aux_at<BF16>(pa, r * k + g);
    }
    __syncthreads();
    for (int s0 = 0; s0 < nb; s0 += SUB) {
      const int ns = min(SUB, nb - s0);
      for (int jj = 0; jj < ns; ++jj) {
        const int j = s0 + jj;
        float v[N_RED];
#pragma unroll
        for (int r = 0; r < N_RED; ++r) v[r] = 0.0f;
        bool inc = false;
        if (!done) {
          float expp, alpha_raw;
          const float alpha = vegs::splat_eval(
              px, py, s_f[0][j], s_f[1][j], s_f[2][j], s_f[3][j], s_f[4][j],
              s_f[5][j], &expp, &alpha_raw);
          if (alpha != 0.0f) {
            const float T = vegs::transmittance(logT);
            if (vegs::crosses(T, alpha, vegs::T_EPS)) {
              done = 1;
            } else {
              inc = true;
              const float chan[N_ACCUM] = {
                  s_a[0][j], s_a[1][j], s_a[2][j], s_f[6][j], s_a[3][j],
                  s_a[4][j], s_a[5][j], s_a[6][j], s_a[7][j], s_a[8][j],
                  s_a[9][j]};
              const float w = alpha * T;
              float dw = 0.0f;
#pragma unroll
              for (int c = 0; c < N_ACCUM; ++c) dw += dacc[c] * chan[c];
              cum += w * dw;
              const float dL = tail - cum;
              const float dalpha = T * dw - dL / (1.0f - alpha);
              if (alpha_raw < vegs::ALPHA_CLAMP) {
                const float dpower = dalpha * alpha;
#pragma unroll
                for (int m = 0; m < 6; ++m) v[m] = dpower * mono[m];
                v[6] = dalpha * expp;
              }
#pragma unroll
              for (int c = 0; c < N_ACCUM; ++c) v[7 + c] = dacc[c] * w;
              logT = vegs::next_logT(logT, alpha);
            }
          }
        }
        if (__any_sync(FULL, inc)) {
#pragma unroll
          for (int r = 0; r < N_RED; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[r] += __shfl_xor_sync(FULL, v[r], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < N_RED; ++r) s_red[warp][r][jj] = v[r];
        }
      }
      __syncthreads();
      if (threadIdx.x < ns) {
        const int jj = threadIdx.x;
        const int j = s0 + jj;
        float t[N_RED];
#pragma unroll
        for (int r = 0; r < N_RED; ++r) {
          t[r] = 0.0f;
          for (int w8 = 0; w8 < nwarps; ++w8) t[r] += s_red[w8][r][jj];
        }
        const float mx = s_f[0][j] - ox;
        const float my = s_f[1][j] - oy;
        const float a = s_f[2][j];
        const float b = s_f[3][j];
        const float c = s_f[4][j];
        const size_t g = static_cast<size_t>(b0 + j);
        dpf[0 * k + g] = t[0] * (-a * mx - b * my) + t[1] * a + t[2] * b;
        dpf[1 * k + g] = t[0] * (-c * my - b * mx) + t[1] * b + t[2] * c;
        dpf[2 * k + g] = t[0] * (-0.5f * mx * mx) + t[1] * mx - 0.5f * t[3];
        dpf[3 * k + g] = t[0] * (-mx * my) + t[1] * my + t[2] * mx - t[5];
        dpf[4 * k + g] = t[0] * (-0.5f * my * my) + t[2] * my - 0.5f * t[4];
        dpf[5 * k + g] = t[6];
        dpf[6 * k + g] = t[7 + 3];  // depth
#pragma unroll
        for (int r = 0; r < 3; ++r) aux_put<BF16>(dpa, r * k + g, t[7 + r]);
#pragma unroll
        for (int r = 3; r < AUX_USED; ++r)
          aux_put<BF16>(dpa, r * k + g, t[7 + 1 + r]);
      }
      // the next sub-batch overwrites s_red
      __syncthreads();
    }
    // Doubles as the barrier before the next batch overwrites shared memory.
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
  }
}

}  // namespace

extern "C" int vegs_blend_bwd(const float* pf, const void* pa, int aux_bf16,
                              const int* tile_starts, int64_t k, int ntx,
                              int nty, int tile_h, int tile_w,
                              const float* out, const float* dout, float* dpf,
                              void* dpa, void* stream) {
  const int hp = nty * tile_h;
  const int wp = ntx * tile_w;
  const dim3 grid(ntx * nty);
  const dim3 block(tile_h * tile_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aux_bf16) {
    blend_bwd_kernel<true><<<grid, block, 0, s>>>(
        pf, pa, tile_starts, k, ntx, tile_h, tile_w, hp, wp, out, dout, dpf,
        dpa);
  } else {
    blend_bwd_kernel<false><<<grid, block, 0, s>>>(
        pf, pa, tile_starts, k, ntx, tile_h, tile_w, hp, wp, out, dout, dpf,
        dpa);
  }
  return static_cast<int>(cudaGetLastError());
}
