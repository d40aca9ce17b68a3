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
// Bound on the H100: bytes. A row holds about K nonzeros of its 128 * M
// block columns, so the dense product is ~99% multiplications by zero; the
// function needs 2 * nnz * F operations and the bytes of the ELL, x and
// out. Design: a gather over the nonzeros (gather.cuh). One warp a row of
// the output, rows of consecutive row tiles in neighbouring blocks (L2
// serves the re-reads of shared neighbours). For each live slot m in order,
// the warp finds the distinct columns j of tile c_m among the row's K ELL
// slots in ascending order (a warp minimum over the slots above the last
// column), sums each column's weights in k order from 0.0 (a ballot, then
// the lanes in order) and rounds the sum to T: block(b, r, m)[i, j], as B1
// and a dense block product form it. A nonzero coefficient whose x row
// lies below NC becomes a term; the terms are added into the row's f32 sums
// in that order, lanes across F in the widest vectors that F and x's base
// allow. The output is the dense product's fmaf chain without its zero
// terms: bit-equal to it for finite x. An edge whose column tile is not
// live for its row tile adds nothing; a tile listed in two live slots adds
// twice; weights of 0 (self slots, padding) drop out.

#include "gather.cuh"

namespace {

using cgc::gather::kFull;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads) bsr_gather_kernel(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const int* __restrict__ blk_cols, const int* __restrict__ blk_mask,
    const T* __restrict__ x, T* __restrict__ out, int B, int N, int K, int R,
    int M, int NC, int F) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * N) return;  // the whole warp
  const long long b = row / N;
  const long long br = b * R + (row % N) / cgc::kTile;
  const int* nb = nbr + row * K;
  const float* wr = w + row * K;
  const T* xb = x + b * NC * static_cast<long long>(F);
  T* orow = out + row * F;
  // the row's first 32 ELL slots and the row tile's first 32 block slots
  // one a lane, read at once (the rest, where K or M pass 32, as needed)
  const int nb0 = lane < K ? nb[lane] : 0;
  const float w0 = lane < K ? wr[lane] : 0.f;
  const int slot0 = lane < M ? blk_cols[br * M + lane] : 0;
  const int live0 = lane < M ? blk_mask[br * M + lane] : 0;
  const int nvec = F / VEC;
  for (int v0 = 0; v0 < nvec; v0 += 32 * NV) {
    cgc::gather::Row<T, VEC, NV> sum(v0, nvec);
    for (int m = 0; m < M; ++m) {
      const int live = m < 32 ? __shfl_sync(kFull, live0, m)
                              : blk_mask[br * M + m];
      if (live == 0) continue;
      const int base = (m < 32 ? __shfl_sync(kFull, slot0, m)
                               : blk_cols[br * M + m]) * cgc::kTile;
      int last = -1;
      for (;;) {
        // the lowest column of this tile above the last one
        unsigned col = UINT_MAX;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          const int c = (k0 == 0 ? nb0 : k < K ? nb[k] : 0) - base;
          if (k < K && c > last && c < cgc::kTile)
            col = min(col, static_cast<unsigned>(c));
        }
        col = __reduce_min_sync(kFull, col);
        if (col == UINT_MAX) break;
        last = static_cast<int>(col);
        // its weights in k order from 0.0, as block(b, r, m) sums them
        float coef = 0.f;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          const bool hit =
              k < K && (k0 == 0 ? nb0 : nb[k]) - base == last;
          const float wk = hit ? (k0 == 0 ? w0 : wr[k]) : 0.f;
          for (unsigned bal = __ballot_sync(kFull, hit); bal; bal &= bal - 1)
            coef += __shfl_sync(kFull, wk, __ffs(bal) - 1);
        }
        coef = cgc::round_to<T>(coef);
        const int xr = base + last;
        if (coef != 0.f && xr >= 0 && xr < NC) {
          sum.reserve(1, lane);
          sum.add(xb + static_cast<long long>(xr) * F, coef, lane);
        }
      }
    }
    sum.flush(lane);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = v0 + lane + 32 * j;
      if (v < nvec)
        cgc::gather::store_vec<T, VEC>(orow + static_cast<long long>(v) * VEC,
                                       sum.acc[j]);
    }
  }
}

template <typename T>
cudaError_t launch(const int* nbr, const float* w, const int* blk_cols,
                   const int* blk_mask, const void* x, void* out, int B, int N,
                   int K, int R, int M, int NC, int F, cudaStream_t s) {
  auto xx = static_cast<const T*>(x);
  auto o = static_cast<T*>(out);
  const long long rows = static_cast<long long>(B) * N;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const int vec = cgc::gather::rows_vec<T>(F, {x, out});
  return cgc::with_vec<T>(vec, [&](auto e) {
    constexpr int E = decltype(e)::value;
    return cgc::gather::with_nv(F / E, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      if (blocks > 0 && F > 0) {
        bsr_gather_kernel<T, E, NV><<<blocks, kThreads, 0, s>>>(
            nbr, w, blk_cols, blk_mask, xx, o, B, N, K, R, M, NC, F);
      }
      return cudaGetLastError();
    });
  });
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
