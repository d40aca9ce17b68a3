// B3 and B5 — the training-mode assign tail of the pooling block: the BN
// batch statistics of conv3's normalized activation, and the backward of
// normalize + relu + statistics to the raw lin output p.
//
// Per row n of batch b (rmask = n < n_nodes[b]):
//   rnorm = 1 / max(||p||, 1e-12)         over the whole raw row
//   h     = relu(p) * rnorm
//
// B3 replaces cgcnet_tpu/ops/pallas/assign_head.py: _stats_call
// (_stats_kernel). It returns ssum[C] = sum_rows round_T(rmask*h) and
// ssq[C] = sum_rows round_T(rmask*h)^2 in f32 (h rounded to the storage
// type T before summing, as the TPU kernel does). Bound on the H100: bytes
// (p read once: 105 MB in f32 at B=4, N=5760, C=1140, ~0.03 ms). The TPU
// carries the sums across a sequential grid; here blocks run in no order, so
// each block of kStatsRows rows writes its own column partials [2, C] and a
// second kernel sums them in a fixed order (warp w of a 32-column block sums
// tiles w, w + 8, ... in order, then the 8 warp sums are added in warp
// order): the result is the same bits run to run (atomics would not be).
// A block first computes its rows' rnorm (one warp per row) into shared
// memory, then each thread owns columns c = t, t + 256, ... and walks the
// tile's rows eight loads at a time, so the loads of a row are coalesced
// and the second read of the tile hits L1/L2. Tiles wholly past n_nodes are
// neither computed nor summed (they add exactly 0).
//
// B9b replaces cgcnet_tpu/ops/pallas/assign_head.py: _stats_call_lin
// (_stats_kernel_lin): B3 with conv3's lin inside the tile — p is never
// stored, each value is formed where it is read from the tile's x3 rows
// (staged in shared memory) and kc3 / b3: p = round_T(round_T(x3 . kc3[:,c])
// + b3[c]). A compile-time switch (LIN) of B3's kernel: same tiles, same
// partials, same reduction, so the sums come in the same fixed order and
// repeat bit for bit. Bound: operations — p is formed twice per element
// (the row norm, then the sums), 4*N*C*F3 (~9 GFLOP at 100k nuclei, F3 =
// 20) on the f32 CUDA cores; x3 is read once (~4 MB in bf16).
//
// B5 replaces cgcnet_tpu/ops/pallas/assign_head.py: _bwd_call (_bwd_kernel):
//   hs     = rmask * h
//   dh_tot = dh + rmask * (u + 2 * hs * w)
//   dp     = rmask * (p > 0) * rnorm * dh_tot - rnorm^2 * p * sum_c(dh_tot*hs)
// written in T, term by term as the TPU kernel does (rows past n_nodes come
// out 0 through the formula: there p is the lin bias, rnorm finite, rd 0).
// Bound: bytes (p and dh read, dp written: 315 MB in f32, ~0.09 ms). One warp
// per row, three passes over the row (||p||, rd, dp); the 4.5 KB row is
// re-read from L1/L2, not from device memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStatsRows = 64;  // rows per stats block; the caller passes its
                                // own value, which must match

template <typename T>
__device__ __forceinline__ float row_rnorm(const T* __restrict__ pr, int C,
                                           int lane) {
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = cgc::to_f32(pr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = cgc::warp_sum(ss);
  return 1.f / fmaxf(sqrtf(ss), 1e-12f);
}

// Number of real rows of the kStatsRows-row tile starting at flat row0.
__device__ __forceinline__ int tile_rows(long long row0, int N,
                                         const int* __restrict__ n_nodes) {
  const long long b = row0 / N;  // N % kStatsRows == 0: one graph per tile
  const long long left = n_nodes[b] - (row0 - b * N);
  return left <= 0 ? 0 : (left < kStatsRows ? static_cast<int>(left)
                                            : kStatsRows);
}

// The conv3 lin operands of B9b: x3 [rows, F3], kc3 [F3, C], b3 [C].
template <typename T>
struct Lin {
  const T* x3;
  const T* kc3;
  const T* b3;
  int F3;
};

// The stats input at (flat row, column): p itself, or (LIN) formed from
// the row's x3 staged at xs.
template <typename T, bool LIN>
__device__ __forceinline__ float p_at(const T* __restrict__ p,
                                      const Lin<T>& lin, const float* xs,
                                      long long row, int C, int c) {
  if (LIN) return cgc::lin_p(xs, lin.kc3, lin.b3, lin.F3, C, c);
  return cgc::to_f32(p[row * C + c]);
}

template <typename T, bool LIN>
__global__ void __launch_bounds__(kThreads)
    stats_partial_kernel(const T* __restrict__ p, Lin<T> lin,
                         const int* __restrict__ n_nodes,
                         float* __restrict__ partial, int N, int C) {
  __shared__ float s_rn[kStatsRows];
  extern __shared__ float s_x3[];  // LIN: [kStatsRows][F3]
  const long long row0 = static_cast<long long>(blockIdx.x) * kStatsRows;
  const int rows = tile_rows(row0, N, n_nodes);
  if (rows == 0) return;  // skipped by the reduction as well
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (LIN) {
    for (int e = t; e < rows * lin.F3; e += kThreads)
      s_x3[e] = cgc::to_f32(lin.x3[row0 * lin.F3 + e]);
    __syncthreads();
  }
  for (int r = warp; r < rows; r += kWarps) {
    float rn;
    if (LIN) {
      const float* xs = s_x3 + r * lin.F3;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = cgc::lin_p(xs, lin.kc3, lin.b3, lin.F3, C, c);
        ss = fmaf(v, v, ss);
      }
      ss = cgc::warp_sum(ss);
      rn = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    } else {
      rn = row_rnorm(p + (row0 + r) * C, C, lane);
    }
    if (lane == 0) s_rn[r] = rn;
  }
  // rows past the tile's last real row give h = 0, an exact no-op below
  if (t >= rows && t < kStatsRows) s_rn[t] = 0.f;
  __syncthreads();
  constexpr int kBatch = 8;  // independent loads in flight per thread
  static_assert(kStatsRows % kBatch == 0, "a batch never passes the tile");
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * C;
  for (int c = t; c < C; c += kThreads) {
    float sum = 0.f, sq = 0.f;
    for (int r0 = 0; r0 < rows; r0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        v[k] = r0 + k < rows
                   ? p_at<T, LIN>(p, lin, s_x3 + (r0 + k) * (LIN ? lin.F3 : 0),
                                  row0 + r0 + k, C, c)
                   : 0.f;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float h = cgc::round_to<T>(fmaxf(v[k], 0.f) * s_rn[r0 + k]);
        sum += h;
        sq = fmaf(h, h, sq);
      }
    }
    out[c] = sum;
    out[C + c] = sq;
  }
}

// out[0, c] = sum over the real tiles of partial[tile, 0, c] (and out[1, c]
// of the squares). One block per 32 columns (lane = column, so a warp reads
// 128 contiguous bytes of a tile); warp w sums tiles w, w + kWarps, ... in
// order, then warp 0 adds the warp sums in warp order.
__global__ void __launch_bounds__(kThreads)
    stats_reduce_kernel(const float* __restrict__ partial,
                        const int* __restrict__ n_nodes,
                        float* __restrict__ out, int tiles, int N, int C) {
  __shared__ float s_sum[kWarps][32], s_sq[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f, sq = 0.f;
  if (c < C) {
    for (int i = warp; i < tiles; i += kWarps) {
      if (tile_rows(static_cast<long long>(i) * kStatsRows, N, n_nodes) == 0)
        continue;
      const float* pt = partial + static_cast<long long>(i) * 2 * C;
      sum += pt[c];
      sq += pt[C + c];
    }
  }
  s_sum[warp][lane] = sum;
  s_sq[warp][lane] = sq;
  __syncthreads();
  if (warp != 0 || c >= C) return;
  float tot = 0.f, tot_sq = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    tot += s_sum[w][lane];
    tot_sq += s_sq[w][lane];
  }
  out[c] = tot;
  out[C + c] = tot_sq;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_kernel(const T* __restrict__ p, const T* __restrict__ dh,
                    const float* __restrict__ u, const float* __restrict__ w,
                    const int* __restrict__ n_nodes, T* __restrict__ dp,
                    int N, long long rows, int C) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long b = row / N;
  const float rmask = (row - b * N < n_nodes[b]) ? 1.f : 0.f;
  const T* pr = p + row * C;
  const T* dhr = dh + row * C;
  const float rnorm = row_rnorm(pr, C, lane);
  float rd = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = cgc::to_f32(pr[c]);
    const float hs = fmaxf(v, 0.f) * rnorm * rmask;
    const float tot = cgc::to_f32(dhr[c]) + rmask * (u[c] + 2.f * hs * w[c]);
    rd = fmaf(tot, hs, rd);
  }
  rd = cgc::warp_sum(rd);
  T* out = dp + row * C;
  for (int c = lane; c < C; c += 32) {
    const float v = cgc::to_f32(pr[c]);
    const float hs = fmaxf(v, 0.f) * rnorm * rmask;
    const float tot = cgc::to_f32(dhr[c]) + rmask * (u[c] + 2.f * hs * w[c]);
    const float pos = v > 0.f ? 1.f : 0.f;
    out[c] = cgc::from_f32<T>(rmask * pos * rnorm * tot -
                              rnorm * rnorm * v * rd);
  }
}

template <typename T, bool LIN>
cudaError_t launch_stats(const void* p, const void* x3, const void* kc3,
                         const void* b3, int F3, const int* n_nodes,
                         float* partial, float* out, int B, int N, int C,
                         cudaStream_t st) {
  const int tiles = static_cast<int>(static_cast<long long>(B) * N / kStatsRows);
  if (C == 0) return cudaGetLastError();
  const Lin<T> lin{static_cast<const T*>(x3), static_cast<const T*>(kc3),
                   static_cast<const T*>(b3), LIN ? F3 : 0};
  const size_t smem = sizeof(float) * kStatsRows * lin.F3;
  if (LIN) {
    cudaError_t err = cudaFuncSetAttribute(
        stats_partial_kernel<T, LIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (tiles > 0)
    stats_partial_kernel<T, LIN><<<tiles, kThreads, smem, st>>>(
        static_cast<const T*>(p), lin, n_nodes, partial, N, C);
  stats_reduce_kernel<<<(C + 31) / 32, kThreads, 0, st>>>(
      partial, n_nodes, out, tiles, N, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* p, const void* dh, const float* u,
                       const float* w, const int* n_nodes, void* dp, int B,
                       int N, int C, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * N;
  if (rows == 0 || C == 0) return cudaGetLastError();
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  tail_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(p), static_cast<const T*>(dh), u, w, n_nodes,
      static_cast<T*>(dp), N, rows, C);
  return cudaGetLastError();
}

}  // namespace

// partial: f32 scratch [B*N/tile_rows, 2, C] sized by the caller from its
// tile_rows, refused unless that is kStatsRows; out: f32 [2, C] (ssum, ssq).
extern "C" int cgc_l2relu_stats(const void* p, const void* n_nodes,
                                void* partial, void* out, int B, int N, int C,
                                int tile_rows, int dtype, int device,
                                void* stream) {
  if (tile_rows != kStatsRows || N % kStatsRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto nn = static_cast<const int*>(n_nodes);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case cgc::kF32:
      return launch_stats<float, false>(p, nullptr, nullptr, nullptr, 0, nn,
                                        part, o, B, N, C, st);
    case cgc::kBF16:
      return launch_stats<__nv_bfloat16, false>(p, nullptr, nullptr, nullptr,
                                                0, nn, part, o, B, N, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// B9b: x3 [B*N, F3], kc3 [F3, C], b3 [C] in the compute type; partial and
// out as for cgc_l2relu_stats.
extern "C" int cgc_l2relu_stats_lin(const void* x3, const void* kc3,
                                    const void* b3, const void* n_nodes,
                                    void* partial, void* out, int B, int N,
                                    int F3, int C, int tile_rows, int dtype,
                                    int device, void* stream) {
  if (tile_rows != kStatsRows || N % kStatsRows || F3 <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto nn = static_cast<const int*>(n_nodes);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case cgc::kF32:
      return launch_stats<float, true>(nullptr, x3, kc3, b3, F3, nn, part, o,
                                       B, N, C, st);
    case cgc::kBF16:
      return launch_stats<__nv_bfloat16, true>(nullptr, x3, kc3, b3, F3, nn,
                                               part, o, B, N, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int cgc_assign_tail_bwd(const void* p, const void* dh,
                                   const void* u, const void* w,
                                   const void* n_nodes, void* dp, int B, int N,
                                   int C, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto uf = static_cast<const float*>(u);
  auto wf = static_cast<const float*>(w);
  auto nn = static_cast<const int*>(n_nodes);
  switch (dtype) {
    case cgc::kF32:
      return launch_bwd<float>(p, dh, uf, wf, nn, dp, B, N, C, st);
    case cgc::kBF16:
      return launch_bwd<__nv_bfloat16>(p, dh, uf, wf, nn, dp, B, N, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}
