// B2 — block-sparse matmul over the precomputed blocks of B1.
//
// Replaces cgcnet_tpu/ops/pallas/bsr_kernel.py: bsr_matmul (the resident
// variant _bsr_mm_resident_kernel and the streamed variant
// _make_streamed_kernel — on this card one kernel serves every width):
//
//   out[b, r*128 : (r+1)*128] = sum_m vals[b, r, m] @ x[b, c*128 : c*128+128]
//   with c = blk_cols[b, r, m],
//
// accumulated in f32 and stored in x's type. The operator may be
// rectangular: x has NC rows, out has R*128; rows of x at or past NC read as
// zero, so the kernel never reads outside x. Padded block slots hold zero
// blocks (B1) and are multiplied like any other.
//
// Bound on the H100: at the narrow widths (F = 18, 40) bytes — the blocks
// (64 KB each in f32) dominate; at F = 1140 operations — 2*128*128*F per
// block, on the f32 CUDA cores (the port keeps f32 exact, no TF32). Design:
// one thread block per (b, r, column chunk of F); it walks the M slots in
// k-steps of 32, staging a [128 x 32] slice of the block (transposed, padded
// against bank conflicts) and the matching [32 x FC] slice of x in shared
// memory, and each of 256 threads keeps an 8 x (FC/16) register tile of f32
// sums. FC is 32, 64 or 128 by F, so F = 18 does not pay for 128 columns.
// Column chunks of one (b, r) are adjacent in the launch order, so the
// blocks that re-read the same 128x128 block find it in L2.

#include "common.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 256;

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads) bsr_matmul_kernel(
    const T* __restrict__ vals, const int* __restrict__ blk_cols,
    const T* __restrict__ x, T* __restrict__ out, int R, int M, int NC,
    int F) {
  constexpr int FC = 16 * CPT;
  __shared__ float As[kBK][cgc::kTile + 1];
  __shared__ float Bs[kBK][FC];

  const long long br = blockIdx.y;  // b * R + r
  const long long b = br / R;
  const int f0 = blockIdx.x * FC;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const T* xb = x + b * NC * static_cast<long long>(F);

  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int m = 0; m < M; ++m) {
    const long long blk = br * M + m;
    const int x_row0 = blk_cols[blk] * cgc::kTile;
    const T* a = vals + blk * cgc::kTile * cgc::kTile;
    for (int k0 = 0; k0 < cgc::kTile; k0 += kBK) {
      for (int e = t; e < cgc::kTile * kBK; e += kThreads) {
        const int row = e / kBK, kk = e % kBK;
        As[kk][row] = cgc::to_f32(a[row * cgc::kTile + k0 + kk]);
      }
      for (int e = t; e < kBK * FC; e += kThreads) {
        const int kk = e / FC, c = e % FC;
        const int xr = x_row0 + k0 + kk;
        const int f = f0 + c;
        Bs[kk][c] = (xr < NC && f < F)
                        ? cgc::to_f32(xb[static_cast<long long>(xr) * F + f])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[8], bv[CPT];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk][ty * 8 + i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bv[j] = Bs[kk][tx + 16 * j];
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
cudaError_t launch_cpt(const T* vals, const int* blk_cols, const T* x, T* out,
                       int B, int R, int M, int NC, int F, cudaStream_t s) {
  constexpr int FC = 16 * CPT;
  const dim3 grid((F + FC - 1) / FC, static_cast<unsigned>(B) * R);
  if (grid.x > 0 && grid.y > 0) {
    bsr_matmul_kernel<T, CPT>
        <<<grid, kThreads, 0, s>>>(vals, blk_cols, x, out, R, M, NC, F);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* vals, const int* blk_cols, const void* x,
                   void* out, int B, int R, int M, int NC, int F,
                   cudaStream_t s) {
  auto v = static_cast<const T*>(vals);
  auto xx = static_cast<const T*>(x);
  auto o = static_cast<T*>(out);
  if (F <= 32) return launch_cpt<T, 2>(v, blk_cols, xx, o, B, R, M, NC, F, s);
  if (F <= 64) return launch_cpt<T, 4>(v, blk_cols, xx, o, B, R, M, NC, F, s);
  return launch_cpt<T, 8>(v, blk_cols, xx, o, B, R, M, NC, F, s);
}

}  // namespace

extern "C" int cgc_bsr_matmul(const void* vals, const void* blk_cols,
                              const void* x, void* out, int B, int R, int M,
                              int NC, int F, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto bc = static_cast<const int*>(blk_cols);
  switch (dtype) {
    case cgc::kF32:
      return launch<float>(vals, bc, x, out, B, R, M, NC, F, s);
    case cgc::kBF16:
      return launch<__nv_bfloat16>(vals, bc, x, out, B, R, M, NC, F, s);
    default:
      return cudaErrorInvalidValue;
  }
}
