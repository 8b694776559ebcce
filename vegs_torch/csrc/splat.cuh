// Per-(pixel, instance) compositing math shared by the blend-forward (K1),
// blend-backward (K2) and saturation-count (K4) kernels, and the pieces of
// K1's and K2's walk: the conservative footprint box of an instance, the
// thread -> pixel map with its compact warp rectangles, and the
// asynchronous staging of a 256-instance batch; on the host, their
// shared-memory opt-in and occupancy query.
//
// The kernels must reach bit-identical decisions on the same instance
// sequence: the saturation cull is lossless only if the blend stops no later
// than the count says, and the backward must include exactly the instances
// the forward included. So the splat exponent is evaluated with explicitly
// rounded intrinsics (__fmul_rn/__fadd_rn/__fsub_rn never contract into
// FMAs) in the operation order of the spec (vegs_tpu/ops/blend_ref.py:16-31),
// which is also the order the plain PyTorch versions evaluate it in.
//
// What bounds K1 and K2 is this per-pair math, evaluated for every pixel
// and every instance of its tile's range although ~91% of those pairs have
// alpha 0. `footprint_box` bounds the pixels an instance can reach, so a
// warp skips every instance whose box misses its 32 pixels: for those the
// math would give alpha = 0 at each of them, so nothing the kernels compute
// changes. The box is derived for the float evaluation below, not for the
// exact one (see its note), and its twin in PyTorch is
// `vegs_torch.ops.blend_cuda.footprint_box`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vegs {

constexpr int PAD_ALIGN = 256;          // slots per window (binning.PAD_ALIGN)
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float NEG_CAP = -80.0f;       // log-transmittance floor
constexpr unsigned FULL_MASK = 0xffffffffu;

// Alpha of one splat at pixel (px, py) under the spec: 0 when the instance
// is skipped (power > 0 or alpha < 1/255), else min(alpha_raw, 0.99).
// The exponent is clamped at 0 before exp, as the Pallas kernel does.
// Also returns exp(min(power, 0)) and alpha_raw = op * that, which the
// backward needs.
__device__ __forceinline__ float splat_eval(float px, float py, float mx,
                                            float my, float a, float b,
                                            float c, float op, float* expp,
                                            float* alpha_raw) {
  const float dx = __fsub_rn(px, mx);
  const float dy = __fsub_rn(py, my);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                __fmul_rn(__fmul_rn(b, dx), dy));
  *expp = expf(fminf(power, 0.0f));
  *alpha_raw = __fmul_rn(op, *expp);
  if (!(power <= 0.0f) || !(*alpha_raw >= ALPHA_MIN)) return 0.0f;
  return fminf(*alpha_raw, ALPHA_CLAMP);
}

__device__ __forceinline__ float splat_alpha(float px, float py, float mx,
                                             float my, float a, float b,
                                             float c, float op) {
  float expp, alpha_raw;
  return splat_eval(px, py, mx, my, a, b, c, op, &expp, &alpha_raw);
}

// Transmittance before an instance, from the carried log T.
__device__ __forceinline__ float transmittance(float logT) {
  return expf(fmaxf(logT, NEG_CAP));
}

// True when including an instance of this alpha would drop T below eps:
// the walk stops BEFORE that instance.
__device__ __forceinline__ bool crosses(float T, float alpha, float eps) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha)) < eps;
}

__device__ __forceinline__ float next_logT(float logT, float alpha) {
  return fmaxf(__fadd_rn(logT, log1pf(-alpha)), NEG_CAP);
}

// ---- the footprint box ----------------------------------------------------
//
// splat_eval accepts a pixel only if op * exp(power) >= 1/255, i.e.
// Q = -2 power = a dx^2 + c dy^2 + 2 b dx dy <= 2 tau with tau = ln(255 op),
// where dx = fl(px - mx), dy = fl(py - my) are the float differences it
// forms. Its float Q differs from the exact Q of those dx, dy by at most
// ~4 * 2^-24 of S = a dx^2 + c dy^2 + 2 |b dx dy| <= (a + |b|) dx^2 +
// (c + |b|) dy^2, and expf and the final product add a few ulps to tau. So
// every accepted (dx, dy) satisfies d^T C' d <= 2 tau' with the diagonal of
// the conic shrunk by BOX_REL (40x the rounding) and tau inflated, and the
// box of that ellipse, |dx| <= sqrt(2 tau' c' / det'), |dy| <= sqrt(2 tau'
// a' / det'), evaluated in double and rounded up, holds every accepted
// pixel. An opacity below 1/255 accepts nothing (alpha_raw <= op): an empty
// box (-inf). A conic that is not positive definite after the shrink, or
// any non-finite input, gets an unbounded box (+inf).
constexpr double BOX_REL = 1e-5;      // relative shrink of the conic diagonal
constexpr double BOX_TAU_REL = 1e-4;  // relative and absolute inflation of tau
constexpr double BOX_TAU_ABS = 1e-4;
constexpr double BOX_MIN_DET = 1e-12;  // det' below this share of a'c': open

__device__ __forceinline__ bool is_finite_f(float x) {
  return fabsf(x) <= 3.402823466e38f;  // false for inf and NaN
}

__device__ __forceinline__ float2 footprint_box(float mx, float my, float a,
                                                float b, float c, float op) {
  const float inf = __int_as_float(0x7f800000);
  if (!(is_finite_f(mx) && is_finite_f(my) && is_finite_f(a) &&
        is_finite_f(b) && is_finite_f(c) && is_finite_f(op)))
    return make_float2(inf, inf);
  if (!(op >= ALPHA_MIN)) return make_float2(-inf, -inf);
  const double tau = fmax(log(255.0 * static_cast<double>(op)), 0.0) *
                         (1.0 + BOX_TAU_REL) + BOX_TAU_ABS;
  const double ab = fabs(static_cast<double>(b));
  const double a2 = a - BOX_REL * (a + ab);
  const double c2 = c - BOX_REL * (c + ab);
  const double det = a2 * c2 - static_cast<double>(b) * b;
  if (!(a2 > 0.0 && c2 > 0.0 && det > BOX_MIN_DET * a2 * c2))
    return make_float2(inf, inf);
  return make_float2(__double2float_ru(sqrt(2.0 * tau * c2 / det)),
                     __double2float_ru(sqrt(2.0 * tau * a2 / det)));
}

// Whether a box of half-widths (rx, ry) around (mx, my) can reach a pixel
// of the rectangle [x0, x1] x [y0, y1] (pixel coordinates): fl(p - m) is
// monotone in p, so every pixel's dx lies in [fl(x0 - mx), fl(x1 - mx)].
// Written with negated comparisons, so that a NaN never rejects.
__device__ __forceinline__ bool box_hits(float x0, float x1, float y0,
                                         float y1, float mx, float my,
                                         float2 r) {
  return !(__fsub_rn(x0, mx) > r.x) && !(__fsub_rn(x1, mx) < -r.x) &&
         !(__fsub_rn(y0, my) > r.y) && !(__fsub_rn(y1, my) < -r.y);
}

// ---- the thread -> pixel map -------------------------------------------------
//
// Each warp takes a compact 8x4 rectangle of its tile when the tile's sides
// allow (tile_w % 8 == 0 and tile_h % 4 == 0: 16x16, 16x32, ...), so that a
// box misses a warp's 32 pixels as often as possible; other tiles keep the
// row-major map. Twin: blend_cuda.thread_pixels.
__device__ __forceinline__ void thread_pixel(int t, int tile_h, int tile_w,
                                             int* lx, int* ly) {
  if (tile_w % 8 == 0 && tile_h % 4 == 0) {
    const int w = t >> 5, l = t & 31, per_row = tile_w / 8;
    *lx = (w % per_row) * 8 + (l & 7);
    *ly = (w / per_row) * 4 + (l >> 3);
  } else {
    *lx = t % tile_w;
    *ly = t / tile_w;
  }
}

// The bounding rectangle of the warp's own pixels, whatever the map.
struct WarpRect {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ WarpRect warp_rect(int gx, int gy) {
  return {static_cast<float>(__reduce_min_sync(FULL_MASK, gx)),
          static_cast<float>(__reduce_max_sync(FULL_MASK, gx)),
          static_cast<float>(__reduce_min_sync(FULL_MASK, gy)),
          static_cast<float>(__reduce_max_sync(FULL_MASK, gy))};
}

// ---- asynchronous staging ------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One batch of the payload rows a blend kernel reads, in shared memory:
// F32_USED f32 rows (mx, my, conic a/b/c, opacity, depth) and AUX_USED aux
// rows (rgb, quat wxyz, scale) in the aux dtype AuxT, PAD_ALIGN slots each.
constexpr int F32_USED = 7;
constexpr int AUX_USED = 10;

template <typename AuxT>
struct Stage {
  float f[F32_USED][PAD_ALIGN];
  AuxT a[AUX_USED][PAD_ALIGN];
};

// Copy slots [b0, b0 + nb) of the rows into `st`, by the calling block.
// When the batch starts on a 16-byte boundary in both payloads (`vec`), it
// is issued as 16-byte cp.async copies (rounded up to whole chunks: k is a
// multiple of 256, so they stay inside the rows) and the caller waits with
// cp_async_wait_all() and a barrier; otherwise it is copied element by
// element, synchronously.
template <typename AuxT>
__device__ __forceinline__ void stage_batch(Stage<AuxT>* st,
                                            const float* __restrict__ pf,
                                            const AuxT* __restrict__ pa,
                                            int64_t k, int b0, int nb,
                                            bool vec) {
  if (vec) {
    constexpr int FV = 16 / sizeof(float);
    constexpr int AV = 16 / sizeof(AuxT);
    const int fch = (nb + FV - 1) / FV;
    const int ach = (nb + AV - 1) / AV;
    for (int i = threadIdx.x; i < F32_USED * fch; i += blockDim.x) {
      const int r = i / fch, ch = i % fch;
      cp_async16(&st->f[r][ch * FV], pf + r * k + b0 + ch * FV);
    }
    for (int i = threadIdx.x; i < AUX_USED * ach; i += blockDim.x) {
      const int r = i / ach, ch = i % ach;
      cp_async16(&st->a[r][ch * AV], pa + r * k + b0 + ch * AV);
    }
    cp_async_commit();
  } else {
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const size_t g = static_cast<size_t>(b0 + j);
#pragma unroll
      for (int r = 0; r < F32_USED; ++r) st->f[r][j] = pf[r * k + g];
#pragma unroll
      for (int r = 0; r < AUX_USED; ++r) st->a[r][j] = pa[r * k + g];
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The footprint box of each of the nb staged instances, by the calling
// block; nothing when the cull is compiled out.
template <bool CULL, typename AuxT>
__device__ __forceinline__ void stage_boxes(const Stage<AuxT>& s,
                                            float2* box, int nb) {
  if constexpr (CULL) {
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      box[j] = footprint_box(s.f[0][j], s.f[1][j], s.f[2][j], s.f[3][j],
                             s.f[4][j], s.f[5][j]);
  }
}

// ---- host side ----------------------------------------------------------------

// Above 48 KB a kernel must be allowed its dynamic shared memory.
template <typename Kern>
inline cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Registers per thread, shared memory per block (bytes), resident blocks
// per SM and local (spill) bytes per thread of `kern` launched with
// `threads` threads and `smem` bytes of dynamic shared memory, into
// res[0..3], as the runtime reports them.
template <typename Kern>
inline int kernel_info(Kern kern, int threads, size_t smem, int* res) {
  cudaError_t e = allow_smem(kern, smem);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  res[0] = attr.numRegs;
  res[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  res[2] = blocks;
  res[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace vegs
