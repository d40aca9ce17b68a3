// Shared helpers of the cgcnet_tpu_torch kernels: storage types, f32
// conversion, vector loads, the row norm of B3 and B4, and the C-interface
// conventions (dtype codes, error return).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// E consecutive values of T as one aligned load or store (E * sizeof(T) <=
// 16 bytes).
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

// E values of T at ``src`` (aligned to E * sizeof(T); global or shared
// memory) in f32.
template <typename T, int E>
__device__ __forceinline__ void load_vec(float (&d)[E],
                                         const T* __restrict__ src) {
  const Vec<T, E> x = *reinterpret_cast<const Vec<T, E>*>(src);
#pragma unroll
  for (int e = 0; e < E; ++e) d[e] = to_f32(x.v[e]);
}

// The widest vector (elements of T, at most 16 bytes) that rows C wide
// starting at ``base`` allow: C a multiple of it and ``base`` aligned to
// it. B3 and B4 read a row in vectors of this width, so on the same p they
// pick the same one.
template <typename T>
inline int row_vec(int C, const void* base) {
  for (int e = 16 / static_cast<int>(sizeof(T)); e > 1; e /= 2)
    if (C % e == 0 &&
        reinterpret_cast<uintptr_t>(base) % (e * sizeof(T)) == 0)
      return e;
  return 1;
}

// f(std::integral_constant<int, E>) for E = e, a width row_vec<T> gives:
// the launch of a kernel templated on its vector width.
template <typename T, typename F>
cudaError_t with_vec(int e, F&& f) {
  switch (e) {
    case 8:
      if constexpr (sizeof(T) <= 2)
        return f(std::integral_constant<int, 8>{});
      return cudaErrorInvalidValue;
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    default:
      return f(std::integral_constant<int, 1>{});
  }
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

// 1 / max(||row||, 1e-12) of a row of ``nvec`` vectors of E values, which
// ``load(v, x)`` puts into x[E] (f32): lane l takes vectors l, l + 32, ...,
// each of its E element positions a chain of fmaf in vector order; the E
// chains are added in order, then the lanes by warp_sum. The one order of
// B3's row norm (assign_tail.cu) and of B4's and f32 B9a's (assign_head.cu
// rnorm_kernel; B9a with E = 1 and p formed by lin_p, through rows_rnorm,
// which keeps this order for several rows at once), so the statistics
// and the head form the same h from the same p, bit for bit. Every lane
// of the warp calls it.
template <int E, typename Load>
__device__ __forceinline__ float row_rnorm(int nvec, int lane, Load&& load) {
  float ss[E] = {};
  for (int v = lane; v < nvec; v += 32) {
    float x[E];
    load(v, x);
#pragma unroll
    for (int e = 0; e < E; ++e) ss[e] = fmaf(x[e], x[e], ss[e]);
  }
  float s = ss[0];
#pragma unroll
  for (int e = 1; e < E; ++e) s += ss[e];
  s = warp_sum(s);
  return 1.f / fmaxf(sqrtf(s), 1e-12f);
}

// row_rnorm<1> of R rows at once, J columns a lane at a time: ``load(c,
// x)`` puts columns c, c + 32, ..., c + 32 (J - 1) of each row into x[J][R]
// (f32), so a value the R rows share (B9a's kc3[k][c]) or the J columns
// share (an x3[r][k]) is read once for all of them. Adds columns [0, ncols)
// into the lane's sums ss[R] — lane l takes l, l + 32, ... in ascending
// order, one fmaf chain a row, as row_rnorm<1> (load may be handed columns
// at or past ncols: they are not added) — so a row cut into slices of a
// multiple of 32 J columns keeps that order across calls;
// rows_rnorm_finish then gives each row's norm by row_rnorm's warp_sum and
// clamp, bit for bit its result. Every lane of the warp calls both.
template <int R, int J, typename Load>
__device__ __forceinline__ void rows_rnorm(float (&ss)[R], int lane,
                                           int ncols, Load&& load) {
  for (int c = lane; c < ncols; c += 32 * J) {
    float x[J][R];
    load(c, x);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (c + 32 * j < ncols) {
#pragma unroll
        for (int r = 0; r < R; ++r) ss[r] = fmaf(x[j][r], x[j][r], ss[r]);
      }
  }
}

template <int R>
__device__ __forceinline__ void rows_rnorm_finish(const float (&ss)[R],
                                                  float (&rn)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    rn[r] = 1.f / fmaxf(sqrtf(warp_sum(ss[r])), 1e-12f);
}

}  // namespace cgc
