// B7 — block-sparse gather-sum with the blocks built on the fly from the ELL.
//
// Replaces cgcnet_tpu/ops/pallas/bsr_kernel.py: bsr_gather_sum, both its
// resident variant (_bsr_resident_call, _bsr_kernel_resident) and its
// streamed variant (_bsr_kernel) — on this card one kernel serves both, as
// B2 does for bsr_matmul:
//
//   out[b, r*128 : (r+1)*128] =
//       sum over slots m with blk_mask[b, r, m] != 0 of
//       round_T(block(b, r, m)) @ x[b, c*128 : c*128+128],  c = blk_cols[b,r,m]
//
// where block(b, r, m)[i, j] sums, in slot order from 0.0, the weights
// w[b, r*128+i, k] of the slots whose column nbr[b, r*128+i, k] is c*128+j
// (f32, the sums B1 builds), rounded to x's type T before the product. The
// product accumulates in f32 and is rounded to T once at the end, as the
// TPU's resident variant does. (Its streamed variant adds each slot's
// product to the output in T, so in bf16 it rounds once per slot; this
// kernel follows the resident variant.) Rows of x at or past NC read as
// zero; slots whose mask is 0 are skipped.
//
// Bound on the H100: operations — 2*128*128*F per real block slot on the
// f32 CUDA cores (no TF32: the port keeps f32 exact); no block values move
// through device memory, only the ELL (nbr, w), x and out. Design: B2's
// kernel with the block built in shared memory instead of read from device
// memory. One thread block of 256 threads per (b, r, column chunk of F);
// for each live slot the threads zero a 128 x 129 f32 tile (padded against
// bank conflicts), thread i < 128 adds row i's K weights into it in slot
// order (one owner per row, no atomics: bit-equal with B1) and rounds the
// row to T, then the tile times the matching [128 x FC] rows of x runs in
// k-steps of 32 with an 8 x (FC/16) register tile of f32 sums per thread.
// FC is 32, 64 or 128 by F. Shared memory: 66 KB of tile plus up to 16 KB
// of x slice, dynamic. The build is redone for each column chunk (9 chunks
// at F = 1140); a later version can keep it across chunks.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPitch = cgc::kTile + 1;
constexpr int kTileFloats = cgc::kTile * kPitch;

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads) bsr_gather_kernel(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const int* __restrict__ blk_cols, const int* __restrict__ blk_mask,
    const T* __restrict__ x, T* __restrict__ out, int N, int K, int R, int M,
    int NC, int F) {
  constexpr int FC = 16 * CPT;
  extern __shared__ float smem[];
  float* tile = smem;                        // [kTile][kPitch]
  float* xs = smem + kTileFloats;            // [kBK][FC]

  const long long br = blockIdx.y;  // b * R + r
  const long long b = br / R;
  const int r = static_cast<int>(br % R);
  const int f0 = blockIdx.x * FC;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const T* xb = x + b * NC * static_cast<long long>(F);
  // the ELL slots of this thread's tile row (threads t < 128 build)
  const long long ell =
      (b * N + static_cast<long long>(r) * cgc::kTile + (t % cgc::kTile)) * K;

  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int m = 0; m < M; ++m) {
    const long long blk = br * M + m;
    if (blk_mask[blk] == 0) continue;  // the same for every thread
    const int base = blk_cols[blk] * cgc::kTile;
    for (int e = t; e < kTileFloats; e += kThreads) tile[e] = 0.f;
    __syncthreads();
    if (t < cgc::kTile) {
      float* row = tile + t * kPitch;
      for (int k = 0; k < K; ++k) {
        const int c = nbr[ell + k] - base;
        if (c >= 0 && c < cgc::kTile) row[c] += w[ell + k];
      }
      if constexpr (!std::is_same<T, float>::value) {
        for (int c = 0; c < cgc::kTile; ++c) row[c] = cgc::round_to<T>(row[c]);
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < cgc::kTile; k0 += kBK) {
      for (int e = t; e < kBK * FC; e += kThreads) {
        const int kk = e / FC, c = e % FC;
        const int xr = base + k0 + kk;
        const int f = f0 + c;
        xs[kk * FC + c] =
            (xr < NC && f < F)
                ? cgc::to_f32(xb[static_cast<long long>(xr) * F + f])
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[8], bv[CPT];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = tile[(ty * 8 + i) * kPitch + k0 + kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bv[j] = xs[kk * FC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  T* ob = out + br * cgc::kTile * static_cast<long long>(F);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < F) ob[static_cast<long long>(row) * F + f] = cgc::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int CPT>
cudaError_t launch_cpt(const int* nbr, const float* w, const int* blk_cols,
                       const int* blk_mask, const T* x, T* out, int B, int N,
                       int K, int R, int M, int NC, int F, cudaStream_t s) {
  constexpr int FC = 16 * CPT;
  constexpr size_t smem = sizeof(float) * (kTileFloats + kBK * FC);
  cudaError_t err = cudaFuncSetAttribute(
      bsr_gather_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((F + FC - 1) / FC, static_cast<unsigned>(B) * R);
  if (grid.x > 0 && grid.y > 0) {
    bsr_gather_kernel<T, CPT><<<grid, kThreads, smem, s>>>(
        nbr, w, blk_cols, blk_mask, x, out, N, K, R, M, NC, F);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const int* nbr, const float* w, const int* blk_cols,
                   const int* blk_mask, const void* x, void* out, int B, int N,
                   int K, int R, int M, int NC, int F, cudaStream_t s) {
  auto xx = static_cast<const T*>(x);
  auto o = static_cast<T*>(out);
  if (F <= 32)
    return launch_cpt<T, 2>(nbr, w, blk_cols, blk_mask, xx, o, B, N, K, R, M,
                            NC, F, s);
  if (F <= 64)
    return launch_cpt<T, 4>(nbr, w, blk_cols, blk_mask, xx, o, B, N, K, R, M,
                            NC, F, s);
  return launch_cpt<T, 8>(nbr, w, blk_cols, blk_mask, xx, o, B, N, K, R, M, NC,
                          F, s);
}

}  // namespace

extern "C" int cgc_bsr_gather_sum(const void* nbr, const void* w,
                                  const void* blk_cols, const void* blk_mask,
                                  const void* x, void* out, int B, int N,
                                  int K, int R, int M, int NC, int F,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto n = static_cast<const int*>(nbr);
  auto ww = static_cast<const float*>(w);
  auto bc = static_cast<const int*>(blk_cols);
  auto bm = static_cast<const int*>(blk_mask);
  switch (dtype) {
    case cgc::kF32:
      return launch<float>(n, ww, bc, bm, x, out, B, N, K, R, M, NC, F, s);
    case cgc::kBF16:
      return launch<__nv_bfloat16>(n, ww, bc, bm, x, out, B, N, K, R, M, NC,
                                   F, s);
    default:
      return cudaErrorInvalidValue;
  }
}
