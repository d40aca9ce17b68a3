// Shared helpers of the cgcnet_tpu_torch kernels: storage types, f32
// conversion, and the C-interface conventions (dtype codes, error return).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cgc {

// dtype codes shared with cgcnet_tpu_torch/ops/_cuda.py (DTYPE_CODES)
enum DtypeCode { kF32 = 0, kBF16 = 1 };

constexpr int kTile = 128;  // BSR block edge (rows and columns)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value through storage type T (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace cgc
