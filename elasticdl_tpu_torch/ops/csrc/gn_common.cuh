// Shared by the GroupNorm forward (group_norm.cu) and backward
// (group_norm_bwd.cu): the block size and float32 <-> storage-type loads
// and stores (float32 or bfloat16; every sum is float32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The forward's affine coefficients for one (batch, channel), formed in
// this association order with no contraction: a = rstd * scale,
// b = bias - mean * a.  The forward writes y = fma(x, a, b); the backward
// re-derives its ReLU mask from the same expression, so the two agree
// bit for bit on every element, boundary ones included.
__device__ __forceinline__ float affine_a(float rstd, float scale) {
  return __fmul_rn(rstd, scale);
}
__device__ __forceinline__ float affine_b(float bias, float mean, float a) {
  return __fsub_rn(bias, __fmul_rn(mean, a));
}

}  // namespace gn
