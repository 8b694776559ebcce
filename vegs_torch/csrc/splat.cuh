// Per-(pixel, instance) compositing math shared by the blend-forward (K1),
// blend-backward (K2) and saturation-count (K4) kernels.
//
// The kernels must reach bit-identical decisions on the same instance
// sequence: the saturation cull is lossless only if the blend stops no later
// than the count says, and the backward must include exactly the instances
// the forward included. So the splat exponent is evaluated with explicitly
// rounded intrinsics (__fmul_rn/__fadd_rn/__fsub_rn never contract into
// FMAs) in the operation order of the spec (vegs_tpu/ops/blend_ref.py:16-31),
// which is also the order the plain PyTorch versions evaluate it in.
#pragma once

#include <cuda_runtime.h>

namespace vegs {

constexpr int PAD_ALIGN = 256;          // slots per window (binning.PAD_ALIGN)
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float NEG_CAP = -80.0f;       // log-transmittance floor

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

}  // namespace vegs
