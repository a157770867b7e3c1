// Shared helpers for the port's hand-written Hopper kernels.
//
// The kernels load and store their tensors in the caller's dtype: float32
// (dtype code 0) or bfloat16 (dtype code 1), and compute in float32 (B1's
// bfloat16 kernel multiplies bf16 on the tensor cores into float32). Each
// exported C function launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one element through the read-only path, as float32
__device__ __forceinline__ float ldg_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_float(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ float leaky_relu_gain(float v, float slope,
                                                 float gain) {
  return (v >= 0.f ? v : v * slope) * gain;
}

}  // namespace vt
