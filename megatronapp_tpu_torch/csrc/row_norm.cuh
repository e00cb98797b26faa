// The pre-projection norm of a bf16 activation row as the fused decode
// kernels (fused_decode.cu) form their product's input, shared with the
// LoRA shrink kernel (lora.cu) so that both compile one copy of this
// arithmetic: the shrink's t = bf16(norm(x)) @ A then starts from the bits
// the fused QKV and fc1 products read.
//
//   stats:  mean = sum(x) / k (layernorm; 0 for rmsnorm), summed by one
//           warp over 8-element slices; rstd = 1 / sqrt(mean((x - mean)^2)
//           + eps), the squares summed with explicit roundings (row_moments,
//           then row_rstd where the statistics are stored);
//   value:  bf16(((x - mean) * rstd) * scale (+ bias)), each step rounded
//           to fp32 as ops/normalization.py does it (norm_value, then the
//           bf16 rounding: norm_round, or two values at a time packed with
//           __floats2bfloat162_rn, which rounds each the same way).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rn {

enum Norm { kNormNone = 0, kNormRms = 1, kNormLayer = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of one row xr of k bf16 values (k % 8 == 0, 16-byte aligned),
// computed by the 32 lanes of one warp together; every lane gets both:
// mean (layernorm; 0 for rmsnorm) and ss = sum((x - mean)^2). A lane adds
// its 8-value pieces in k order; BATCH pieces are loaded before they are
// added (the loads in flight together, the same sums).
template <int BATCH = 1>
__device__ __forceinline__ void row_moments(const __nv_bfloat16* xr, int k, int norm,
                                            int lane, float& mean, float& ss) {
  constexpr int kStep = 32 * 8;
  mean = 0.f;
  if (norm == kNormLayer) {
    float s = 0.f;
    for (int c0 = lane * 8; c0 < k; c0 += BATCH * kStep) {
      uint4 raw[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (c0 + b * kStep < k) raw[b] = *reinterpret_cast<const uint4*>(xr + c0 + b * kStep);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (c0 + b * kStep >= k) break;
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw[b]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += __bfloat162float(v[e]);
      }
    }
    mean = warp_sum(s) / (float)k;
  }
  ss = 0.f;
  for (int c0 = lane * 8; c0 < k; c0 += BATCH * kStep) {
    uint4 raw[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      if (c0 + b * kStep < k) raw[b] = *reinterpret_cast<const uint4*>(xr + c0 + b * kStep);
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (c0 + b * kStep >= k) break;
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw[b]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(__bfloat162float(v[e]), mean);
        ss = __fadd_rn(ss, __fmul_rn(d, d));
      }
    }
  }
  ss = warp_sum(ss);
}

// 1 / sqrt(mean((x - mean)^2) + eps) of a row's ss over k values.
__device__ __forceinline__ float row_rstd(float ss, int k, float eps) {
  return 1.f / sqrtf(ss / (float)k + eps);
}

// norm(v) of one element before its bf16 rounding: ((v - mean) * rstd) *
// scale (+ bias), each step rounded to fp32.
__device__ __forceinline__ float norm_value(float v, float mean, float rstd, float scale,
                                            bool has_bias, float bias) {
  float t = __fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), scale);
  return has_bias ? __fadd_rn(t, bias) : t;
}

// bf16(norm(v)) of the row's element kk, as a float.
template <typename TV>
__device__ __forceinline__ float norm_round(float v, float mean, float rstd,
                                            const TV* scale, const TV* bias, int kk) {
  return round_bf16(norm_value(v, mean, rstd, load_f(scale, kk), bias != nullptr,
                               bias != nullptr ? load_f(bias, kk) : 0.f));
}

}  // namespace rn
