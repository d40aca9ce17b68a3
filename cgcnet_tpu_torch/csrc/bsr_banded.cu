// B8 — banded block-sparse matmul of the whole-slide path.
//
// Replaces cgcnet_tpu/ops/pallas/bsr_kernel.py: bsr_matmul_banded, both TPU
// variants (_banded_kernel, the resident halo tail, and _banded_halo_kernel,
// the halo windows) as one kernel:
//
//   out[b, r*128 + i] = sum_m vals[b, r, m] @ xx[b, c*128 : c*128 + 128]
//   with c = blk_cols[b, r, m], xx = [x ++ halo]:
//     c <  ns_tiles: rows of x;
//     c >= ns_tiles: rows (c - ns_tiles)*128.. of halo, or of x itself
//                    (row c*128) when no separate halo is given,
//
// int8 block values converted to x's type (exact), f32 sums in slot order,
// then either
//   acc:      rows < NA get out + acc (acc in f32), rows >= NA go to a
//             second output, both rounded once to x's type;
//   epilogue: scale*out + self_w*x_row with scale, self_w in lanes 0 and 1
//             of a [R*128, 128] array;
//   neither:  out rounded to x's type.
// The concat [x ++ halo] is never formed.
//
// The TPU kernels keep a window of W_BAND column tiles per super tile of
// G_BAND row tiles (and the halo tiles) in fast memory; the window tables
// only decide which tiles those are. This first kernel reads each x tile
// from device memory (L2 serves the re-reads of neighbouring row tiles), so
// it needs no table; the wrapper refuses operators that break the window
// contract, which the TPU kernel would compute wrongly.
//
// Bound on the H100: operations at the slide's wide leg (F = 1140-1152:
// 2*128*128*F per block slot, ~266 GFLOP at 100k nuclei with M = 9) on the
// f32 CUDA cores. Design: B2's SIMT tile — one thread block per (b, r,
// column chunk of F), k-steps of 32 staging a transposed [128 x 32] slice of
// the block and the [32 x FC] slice of x in shared memory, an 8 x (FC/16)
// f32 register tile per thread; the chunks of one row tile run adjacent so
// the block is read from L2 after its first chunk.

#include "common.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 256;

template <typename V, typename T, int CPT>
__global__ void __launch_bounds__(kThreads) banded_kernel(
    const V* __restrict__ vals, const int* __restrict__ blk_cols,
    const T* __restrict__ x, const T* __restrict__ halo,
    const T* __restrict__ acc, const T* __restrict__ sw, T* __restrict__ out,
    T* __restrict__ out_tail, int R, int M, int ns_tiles, int NX, int NH,
    int F, int NA) {
  constexpr int FC = 16 * CPT;
  __shared__ float As[kBK][cgc::kTile + 1];
  __shared__ float Bs[kBK][FC];

  const long long br = blockIdx.y;  // b * R + r
  const long long b = br / R;
  const int r = static_cast<int>(br % R);
  const int f0 = blockIdx.x * FC;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const T* xb = x + b * NX * static_cast<long long>(F);
  const T* hb = halo ? halo + b * NH * static_cast<long long>(F) : nullptr;

  float sum[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) sum[i][j] = 0.f;

  for (int m = 0; m < M; ++m) {
    const long long blk = br * M + m;
    const int c = blk_cols[blk];
    // the column tile's source rows: x's own tiles, then the halo
    const T* src = xb;
    int row0 = c * cgc::kTile, nrows = NX;
    if (c >= ns_tiles && hb != nullptr) {
      src = hb;
      row0 = (c - ns_tiles) * cgc::kTile;
      nrows = NH;
    }
    const V* a = vals + blk * cgc::kTile * cgc::kTile;
    for (int k0 = 0; k0 < cgc::kTile; k0 += kBK) {
      for (int e = t; e < cgc::kTile * kBK; e += kThreads) {
        const int row = e / kBK, kk = e % kBK;
        As[kk][row] = cgc::to_f32(a[row * cgc::kTile + k0 + kk]);
      }
      for (int e = t; e < kBK * FC; e += kThreads) {
        const int kk = e / FC, cc = e % FC;
        const int xr = row0 + k0 + kk;
        const int f = f0 + cc;
        Bs[kk][cc] = (xr >= 0 && xr < nrows && f < F)
                         ? cgc::to_f32(src[static_cast<long long>(xr) * F + f])
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
          for (int j = 0; j < CPT; ++j)
            sum[i][j] = fmaf(av[i], bv[j], sum[i][j]);
      }
      __syncthreads();
    }
  }

  // acc / split outputs and the epilogue take B == 1 (the wrapper checks)
  const long long rows_b = static_cast<long long>(R) * cgc::kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = static_cast<long long>(r) * cgc::kTile + ty * 8 + i;
    float sc = 0.f, sf = 0.f;
    if (sw != nullptr) {
      sc = cgc::to_f32(sw[row * 128]);
      sf = cgc::to_f32(sw[row * 128 + 1]);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f >= F) continue;
      float v = sum[i][j];
      if (acc != nullptr) {
        if (row < NA) {
          out[row * F + f] =
              cgc::from_f32<T>(v + cgc::to_f32(acc[row * F + f]));
        } else {
          out_tail[(row - NA) * F + f] = cgc::from_f32<T>(v);
        }
        continue;
      }
      if (sw != nullptr) v = sc * v + sf * cgc::to_f32(xb[row * F + f]);
      out[(b * rows_b + row) * F + f] = cgc::from_f32<T>(v);
    }
  }
}

template <typename V, typename T, int CPT>
cudaError_t launch_cpt(const void* vals, const int* blk_cols, const void* x,
                       const void* halo, const void* acc, const void* sw,
                       void* out, void* out_tail, int B, int R, int M,
                       int ns_tiles, int NX, int NH, int F, int NA,
                       cudaStream_t s) {
  constexpr int FC = 16 * CPT;
  const dim3 grid((F + FC - 1) / FC, static_cast<unsigned>(B) * R);
  if (grid.x > 0 && grid.y > 0) {
    banded_kernel<V, T, CPT><<<grid, kThreads, 0, s>>>(
        static_cast<const V*>(vals), blk_cols, static_cast<const T*>(x),
        static_cast<const T*>(halo), static_cast<const T*>(acc),
        static_cast<const T*>(sw), static_cast<T*>(out),
        static_cast<T*>(out_tail), R, M, ns_tiles, NX, NH, F, NA);
  }
  return cudaGetLastError();
}

template <typename V, typename T>
cudaError_t launch(const void* vals, const int* blk_cols, const void* x,
                   const void* halo, const void* acc, const void* sw,
                   void* out, void* out_tail, int B, int R, int M,
                   int ns_tiles, int NX, int NH, int F, int NA,
                   cudaStream_t s) {
  if (F <= 32)
    return launch_cpt<V, T, 2>(vals, blk_cols, x, halo, acc, sw, out,
                               out_tail, B, R, M, ns_tiles, NX, NH, F, NA, s);
  if (F <= 64)
    return launch_cpt<V, T, 4>(vals, blk_cols, x, halo, acc, sw, out,
                               out_tail, B, R, M, ns_tiles, NX, NH, F, NA, s);
  return launch_cpt<V, T, 8>(vals, blk_cols, x, halo, acc, sw, out, out_tail,
                             B, R, M, ns_tiles, NX, NH, F, NA, s);
}

}  // namespace

// halo, acc, epilogue_sw and out_tail may be null; out_tail is needed
// exactly when acc covers NA < R*128 rows. vals_dtype: x's code or kI8.
extern "C" int cgc_bsr_matmul_banded(
    const void* vals, const void* blk_cols, const void* x, const void* halo,
    const void* acc, const void* epilogue_sw, void* out, void* out_tail,
    int B, int R, int M, int ns_tiles, int NX, int NH, int F, int NA,
    int vals_dtype, int dtype, int device, void* stream) {
  if ((acc != nullptr || epilogue_sw != nullptr) && B != 1)
    return cudaErrorInvalidValue;
  if (acc != nullptr && NA < R * cgc::kTile && out_tail == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto bc = static_cast<const int*>(blk_cols);
  const bool i8 = vals_dtype == cgc::kI8;
  if (!i8 && vals_dtype != dtype) return cudaErrorInvalidValue;
  switch (dtype) {
    case cgc::kF32:
      return i8 ? launch<int8_t, float>(vals, bc, x, halo, acc, epilogue_sw,
                                        out, out_tail, B, R, M, ns_tiles, NX,
                                        NH, F, NA, s)
                : launch<float, float>(vals, bc, x, halo, acc, epilogue_sw,
                                       out, out_tail, B, R, M, ns_tiles, NX,
                                       NH, F, NA, s);
    case cgc::kBF16:
      return i8 ? launch<int8_t, __nv_bfloat16>(vals, bc, x, halo, acc,
                                                epilogue_sw, out, out_tail, B,
                                                R, M, ns_tiles, NX, NH, F, NA,
                                                s)
                : launch<__nv_bfloat16, __nv_bfloat16>(
                      vals, bc, x, halo, acc, epilogue_sw, out, out_tail, B,
                      R, M, ns_tiles, NX, NH, F, NA, s);
    default:
      return cudaErrorInvalidValue;
  }
}
