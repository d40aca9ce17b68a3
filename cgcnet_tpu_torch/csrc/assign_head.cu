// B4 — fused assign head of the pooling block ("pre" mode).
//
// Replaces cgcnet_tpu/ops/pallas/assign_head.py: _fwd_call_pre
// (_kernel_pre). Per row n of batch b, with rnorm over the WHOLE raw row p
// (before relu):
//
//   rnorm  = 1 / max(||p||, 1e-12)
//   h      = round_T(relu(p) * rnorm)          (T = the storage type)
//   logits = x12 @ K12 + h @ K3f + const       (f32 accumulation)
//   S      = softmax(logits) in f32, rows n >= n_nodes[b] exactly 0
//
// Bound on the H100: operations. The product is [B*N x (F12+C)] x
// [(F12+C) x C] — 62 GFLOP at the canonical B=4, N=5760, F12=40, C=1140 —
// on the f32 CUDA cores (no TF32: the port keeps f32 exact). The 1140-wide
// f32 logits row of a 128-row tile does not fit in shared memory, so the
// work is three launches on one stream:
//   1. rnorm_kernel: one warp per row, f32 sum of squares -> rnorm scratch;
//   2. gemm_kernel: a 128x128 output tile per block, k-steps of 32 over x12
//      @ K12 and then h @ K3f (h formed on load from p and the tile's rnorm,
//      staged in shared memory), 8x8 f32 register tile per thread, each
//      thread's global loads of a k-step issued together into registers;
//      writes logits + const to an f32 buffer (S itself in f32, a scratch
//      buffer in bf16). Tiles wholly past n_nodes are skipped;
//   3. softmax_kernel: one warp per row, max / sum / normalize passes over
//      the f32 logits, writes S in T (in place in f32: each lane reads an
//      element before it writes it).
// S^T is not written: the caller takes S.transpose(1, 2) as a view.

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rnorm_kernel(const T* __restrict__ p, float* __restrict__ rnorm,
                 long long rows, int C) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* pr = p + row * C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = cgc::to_f32(pr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = cgc::warp_sum(ss);
  if (lane == 0) rnorm[row] = 1.f / fmaxf(sqrtf(ss), 1e-12f);
}

// One k-step of the 128x128 tile: 8x8 outer products per thread.
__device__ __forceinline__ void tile_fma(const float (&As)[kBK][kBM + 1],
                                         const float (&Bs)[kBK][kBN], int tx,
                                         int ty, float (&acc)[8][8]) {
#pragma unroll 8
  for (int kk = 0; kk < kBK; ++kk) {
    float av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = As[kk][ty * 8 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc += A[row0 : row0+128, 0:kdim] @ W[0:kdim, col0 : col0+128], A row
// stride lda. HEAD: A is the raw p, formed into h = round_T(relu(p)*rnorm)
// on load. Each thread owns a fixed k column of the A slice (t % 32) and a
// fixed output column of the W slice (t % 128), so its 16 + 16 loads per
// k-step are issued together into registers before any shared-memory store.
template <typename T, bool HEAD>
__device__ __forceinline__ void gemm_part(
    const T* __restrict__ a, int lda, const T* __restrict__ w, int ldw,
    int kdim, long long row0, int col0, int ncols, const float* s_rn,
    float (&As)[kBK][kBM + 1], float (&Bs)[kBK][kBN], float (&acc)[8][8]) {
  constexpr int kAPer = kBM * kBK / kThreads;   // 16 A values per thread
  constexpr int kBPer = kBK * kBN / kThreads;   // 16 W values per thread
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int a_k = t % kBK, a_r = t / kBK;       // A rows a_r + 8 i
  const int b_c = t % kBN, b_k = t / kBN;       // W rows b_k + 2 i
  const bool col_ok = col0 + b_c < ncols;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    float va[kAPer], vb[kBPer];
    const bool a_ok = k0 + a_k < kdim;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const long long row = row0 + a_r + (kThreads / kBK) * i;
      va[i] = a_ok ? cgc::to_f32(a[row * lda + k0 + a_k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int k = k0 + b_k + (kThreads / kBN) * i;
      vb[i] = (col_ok && k < kdim)
                  ? cgc::to_f32(w[static_cast<long long>(k) * ldw + col0 + b_c])
                  : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int r = a_r + (kThreads / kBK) * i;
      float v = va[i];
      if (HEAD) v = cgc::round_to<T>(fmaxf(v, 0.f) * s_rn[r]);
      As[a_k][r] = v;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) Bs[b_k + (kThreads / kBN) * i][b_c] = vb[i];
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const T* __restrict__ x12, const T* __restrict__ p,
    const float* __restrict__ rnorm, const T* __restrict__ k12,
    const T* __restrict__ k3f, const float* __restrict__ cnst,
    const int* __restrict__ n_nodes, float* logits, int N, int F12, int C) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  __shared__ float s_rn[kBM];

  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long b = row0 / N;  // N % 128 == 0: a tile lies in one graph
  if (row0 - b * N >= n_nodes[b]) return;  // every row of the tile is padding
  const int col0 = blockIdx.x * kBN;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  if (t < kBM) s_rn[t] = rnorm[row0 + t];
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gemm_part<T, false>(x12, F12, k12, C, F12, row0, col0, C, s_rn, As, Bs, acc);
  gemm_part<T, true>(p, C, k3f, C, C, row0, col0, C, s_rn, As, Bs, acc);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < C) logits[row * C + col] = acc[i][j] + cnst[col];
    }
  }
}

// logits and s may alias (f32): no __restrict__ on them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_kernel(const float* logits, const int* __restrict__ n_nodes, T* s,
                   int N, long long rows, int C) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long b = row / N;
  T* sr = s + row * C;
  if (row - b * N >= n_nodes[b]) {
    for (int c = lane; c < C; c += 32) sr[c] = cgc::from_f32<T>(0.f);
    return;
  }
  const float* lr = logits + row * C;
  float m = __int_as_float(0xff800000);  // -inf
  for (int c = lane; c < C; c += 32) m = fmaxf(m, lr[c]);
  m = cgc::warp_max(m);
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += expf(lr[c] - m);
  sum = cgc::warp_sum(sum);
  for (int c = lane; c < C; c += 32) {
    const float e = expf(lr[c] - m);
    sr[c] = cgc::from_f32<T>(e / sum);
  }
}

template <typename T>
cudaError_t launch(const void* x12, const void* p, const void* k12,
                   const void* k3f, const float* cnst, const int* n_nodes,
                   float* rnorm, float* logits, void* s, int B, int N, int F12,
                   int C, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * N;
  if (rows == 0 || C == 0) return cudaGetLastError();
  const unsigned warp_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  rnorm_kernel<T><<<warp_blocks, kThreads, 0, st>>>(static_cast<const T*>(p),
                                                    rnorm, rows, C);
  const dim3 grid((C + kBN - 1) / kBN, static_cast<unsigned>(rows / kBM));
  gemm_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x12), static_cast<const T*>(p), rnorm,
      static_cast<const T*>(k12), static_cast<const T*>(k3f), cnst, n_nodes,
      logits, N, F12, C);
  softmax_kernel<T><<<warp_blocks, kThreads, 0, st>>>(
      logits, n_nodes, static_cast<T*>(s), N, rows, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cgc_assign_head_pre(const void* x12, const void* p,
                                   const void* k12, const void* k3f,
                                   const void* cnst, const void* n_nodes,
                                   void* rnorm, void* logits, void* s, int B,
                                   int N, int F12, int C, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cnst);
  auto nn = static_cast<const int*>(n_nodes);
  auto rn = static_cast<float*>(rnorm);
  auto lg = static_cast<float*>(logits);
  switch (dtype) {
    case cgc::kF32:
      return launch<float>(x12, p, k12, k3f, c, nn, rn, lg, s, B, N, F12, C, st);
    case cgc::kBF16:
      return launch<__nv_bfloat16>(x12, p, k12, k3f, c, nn, rn, lg, s, B, N,
                                   F12, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}
