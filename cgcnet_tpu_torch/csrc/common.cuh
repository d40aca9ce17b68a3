// Shared helpers of the cgcnet_tpu_torch kernels: storage types, f32
// conversion, and the C-interface conventions (dtype codes, error return).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgc {

// dtype codes shared with cgcnet_tpu_torch/ops/_cuda.py (DTYPE_CODES, and
// VALS_CODES for block values, which may also be int8)
enum DtypeCode { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kTile = 128;  // BSR block edge (rows and columns)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// int8 block values (the slide path's binary operator) are exact in bf16 and
// f32, so converting to x's type and then to f32 is this one conversion
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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
// f32 -> int8 truncates toward zero, saturating (XLA's convert)
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return static_cast<int8_t>(fminf(fmaxf(truncf(v), -128.f), 127.f));
}

// Round an f32 value through storage type T (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// conv3's lin output for one row and column, computed where it is used (B9a,
// B9b): p = round_T(round_T(x3 . kc3[:, c]) + b3[c]) — an f32 dot in k
// order, rounded to the compute type, plus the bias in that type (the TPU
// kernels' rounding). ``xs`` is the row of x3 in f32 (shared memory).
template <typename T>
__device__ __forceinline__ float lin_p(const float* xs,
                                       const T* __restrict__ kc3,
                                       const T* __restrict__ b3, int F3,
                                       int C, int c) {
  float acc = 0.f;
  for (int k = 0; k < F3; ++k)
    acc = fmaf(xs[k], to_f32(kc3[static_cast<long long>(k) * C + c]), acc);
  return round_to<T>(round_to<T>(acc) + to_f32(b3[c]));
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
