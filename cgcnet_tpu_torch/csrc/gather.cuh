// Gathers over the nonzeros of a sparse row, shared by B7 (bsr_gather.cu)
// and B8's SIMT kernel (bsr_banded.cu).
//
// One warp owns one output row. It finds the row's nonzero terms (a
// coefficient and the source row of x it multiplies) in the order the dense
// block product would add them, holds them one a lane (term p in lane
// p % 32), and when 32 are held, and at the end, adds them into the row's
// f32 sums: lane l holds vectors l, l + 32, ... of VEC columns (NV of them
// a pass), and for each term in turn reads its source row's vectors and
// adds coefficient x value by fmaf. Each output column is then the dense
// product's fmaf chain with its zero terms left out: for finite x,
// fmaf(0, x, s) == s bit for bit (the sums start at +0 and never become
// -0), so the result is the dense kernel's, in f32 and in bf16.
#pragma once

#include <algorithm>
#include <climits>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace cgc {
namespace gather {

constexpr unsigned kFull = 0xffffffffu;

// The widest vector (elements of T, at most 16 bytes) that rows F wide
// allow at every base in ``bases`` (a null base allows any width).
template <typename T>
inline int rows_vec(int F, std::initializer_list<const void*> bases) {
  int e = 16 / static_cast<int>(sizeof(T));
  for (const void* p : bases) e = std::min(e, row_vec<T>(F, p));
  return e;
}

// f(std::integral_constant<int, NV>) with NV vectors a lane, enough for
// ``nvec`` vectors a row in one pass of the warp where NV <= 9; wider rows
// take several passes of 9.
template <typename F>
cudaError_t with_nv(int nvec, F&& f) {
  const int need = (nvec + 31) / 32;
  if (need <= 1) return f(std::integral_constant<int, 1>{});
  if (need <= 3) return f(std::integral_constant<int, 3>{});
  return f(std::integral_constant<int, 9>{});
}

// One output row's sums for the vectors [v0, v0 + 32 NV) of a pass, and
// the terms found but not yet added. Every lane of the warp calls each
// member with the same (warp-uniform) arguments but ``lane``.
template <typename T, int VEC, int NV>
struct Row {
  float acc[NV][VEC];
  const T* src;  // this lane's held term: its source row
  float coef;
  int held;      // terms held (warp-uniform)
  int v0, nvec;

  __device__ __forceinline__ Row(int v0_, int nvec_)
      : src(nullptr), coef(0.f), held(0), v0(v0_), nvec(nvec_) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  }

  // room for n more terms: the held ones are added first if need be (one
  // call site of flush in a caller's loop, not one per add)
  __device__ __forceinline__ void reserve(int n, int lane) {
    if (held + n > 32) flush(lane);
  }

  // the next term, after reserve: c x row (``row`` the source row's first
  // element)
  __device__ __forceinline__ void add(const T* row, float c, int lane) {
    if (lane == held) {
      src = row;
      coef = c;
    }
    ++held;
  }

  // add the held terms in order; two terms' loads are in flight at once
  __device__ __forceinline__ void flush(int lane) {
#pragma unroll 2
    for (int p = 0; p < held; ++p) {
      const T* s = reinterpret_cast<const T*>(__shfl_sync(
          kFull, reinterpret_cast<unsigned long long>(src), p));
      const float c = __shfl_sync(kFull, coef, p);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = v0 + lane + 32 * j;
        if (v < nvec) {
          float xv[VEC];
          load_vec<T, VEC>(xv, s + static_cast<long long>(v) * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(c, xv[e], acc[j][e]);
        }
      }
    }
    held = 0;
  }
};

// ``vals`` (E = VEC values in f32) stored as one aligned vector at ``dst``
template <typename T, int E>
__device__ __forceinline__ void store_vec(T* dst, const float (&vals)[E]) {
  Vec<T, E> o;
#pragma unroll
  for (int e = 0; e < E; ++e) o.v[e] = from_f32<T>(vals[e]);
  *reinterpret_cast<Vec<T, E>*>(dst) = o;
}

}  // namespace gather
}  // namespace cgc
