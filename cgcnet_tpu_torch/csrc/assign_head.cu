// B4, B6 and B9a — fused assign head of the pooling block.
//
// B4 replaces cgcnet_tpu/ops/pallas/assign_head.py: _fwd_call_pre
// (_kernel_pre), the "pre" mode. Per row n of batch b, with rnorm over the
// WHOLE raw row p (before relu):
//
//   rnorm  = 1 / max(||p||, 1e-12)
//   h      = round_T(relu(p) * rnorm)          (T = the storage type)
//   logits = x12 @ K12 + h @ K3f + const       (f32 accumulation)
//   S      = softmax(logits) in f32, rows n >= n_nodes[b] exactly 0
//
// With c_out > C (the slide path's training tail) S is written c_out wide,
// its columns C..c_out-1 exact zeros born in the kernel.
//
// B6 replaces cgcnet_tpu/ops/pallas/assign_head.py: _fwd_call (_kernel),
// the same head without the normalize step: the second operand is conv3's
// activation h3a itself, logits = x12 @ K12 + h3a @ K3f + const.
//
// B9a replaces cgcnet_tpu/ops/pallas/assign_head.py: _fwd_call_pre_lin
// (_kernel_pre_lin), B4 with conv3's lin inside: p is never stored, it is
// formed wherever it is read from x3 [N, F3] and the lin kernel kc3 [F3, C]
// and bias b3: p = round_T(round_T(x3 . kc3[:, c]) + b3[c]).
//
// One kernel set for the three; compile-time switches PRE (normalize step)
// and LIN (p from x3). Bound on the H100: operations. The product is
// [B*N x (F12+C)] x [(F12+C) x C] (62 GFLOP at the canonical B=4, N=5760,
// F12=40, C=1140; 2*N*C*(F12+C) = 276 GFLOP at a 100k-nuclei slide) on the
// f32 CUDA cores. The 1140-wide f32 logits row of a 128-row tile does not
// fit in shared memory, so the work is three launches on one stream (two
// for B6):
//   1. rnorm_kernel (B4, B9a): one warp per row, f32 sum of squares of the
//      row -> rnorm scratch; B9a forms each p of the row from x3 (staged in
//      shared memory) and kc3 — the row's norm needs all of it, and storing
//      p would be the [N, C] tensor B9a exists to avoid, so B9a computes p
//      twice (here and on load below): 2*N*C*F3 more operations (~9 GFLOP
//      at 100k nuclei, F3 = 20), ~3% of the product;
//   2. gemm_kernel: a 128x128 output tile per block, k-steps of 32 over x12
//      @ K12 and then h @ K3f (B4: h formed on load from p and the tile's
//      rnorm; B9a: p itself formed on load from the tile's x3 rows, staged
//      in shared memory, and a kc3 column held in registers; B6: h3a as it
//      is), 8x8 f32 register tile per thread, each thread's global loads of
//      a k-step issued together into registers; writes logits + const to an
//      f32 buffer. Tiles wholly past n_nodes are skipped;
//   3. softmax_kernel: one warp per row, max / sum / normalize passes over
//      the f32 logits, writes S in T (in place in f32 when c_out == C: each
//      lane reads an element before it writes it), zeros past C.
// S^T is not written: the caller takes S.transpose(1, 2) as a view.

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;

// The x3 operand of B9a: x3 [rows, F3], kc3 [F3, C], b3 [C] in T.
template <typename T>
struct Lin {
  const T* x3;
  const T* kc3;
  const T* b3;
  int F3;
};

template <typename T, bool LIN>
__global__ void __launch_bounds__(kThreads)
    rnorm_kernel(const T* __restrict__ p, Lin<T> lin,
                 float* __restrict__ rnorm, long long rows, int C) {
  extern __shared__ float s_x3[];  // LIN: [kThreads / 32][F3]
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (row >= rows) return;
  float* xs = s_x3 + warp * (LIN ? lin.F3 : 0);
  if (LIN) {
    for (int k = lane; k < lin.F3; k += 32)
      xs[k] = cgc::to_f32(lin.x3[row * lin.F3 + k]);
    __syncwarp();
  }
  const T* pr = p + row * C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = LIN ? cgc::lin_p(xs, lin.kc3, lin.b3, lin.F3, C, c)
                        : cgc::to_f32(pr[c]);
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
// on load; LIN (with HEAD): p itself is formed from the tile's x3 rows
// (s_x3, [kBM][F3]) and column k of kc3. Each thread owns a fixed k column
// of the A slice (t % 32) and a fixed output column of the W slice
// (t % 128), so its 16 + 16 loads per k-step are issued together into
// registers before any shared-memory store.
template <typename T, bool HEAD, bool LIN>
__device__ __forceinline__ void gemm_part(
    const T* __restrict__ a, int lda, const T* __restrict__ w, int ldw,
    int kdim, long long row0, int col0, int ncols, const float* s_rn,
    const float* s_x3, const Lin<T>& lin, float (&As)[kBK][kBM + 1],
    float (&Bs)[kBK][kBN], float (&acc)[8][8]) {
  constexpr int kAPer = kBM * kBK / kThreads;   // 16 A values per thread
  constexpr int kBPer = kBK * kBN / kThreads;   // 16 W values per thread
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int a_k = t % kBK, a_r = t / kBK;       // A rows a_r + 8 i
  const int b_c = t % kBN, b_k = t / kBN;       // W rows b_k + 2 i
  const bool col_ok = col0 + b_c < ncols;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    float va[kAPer], vb[kBPer];
    const bool a_ok = k0 + a_k < kdim;
    if (LIN) {
#pragma unroll
      for (int i = 0; i < kAPer; ++i) va[i] = 0.f;
      if (a_ok) {
        const int c = k0 + a_k;
        for (int k = 0; k < lin.F3; ++k) {
          const float wk =
              cgc::to_f32(lin.kc3[static_cast<long long>(k) * kdim + c]);
#pragma unroll
          for (int i = 0; i < kAPer; ++i)
            va[i] = fmaf(s_x3[(a_r + (kThreads / kBK) * i) * lin.F3 + k], wk,
                         va[i]);
        }
        const float bias = cgc::to_f32(lin.b3[c]);
#pragma unroll
        for (int i = 0; i < kAPer; ++i)
          va[i] = cgc::round_to<T>(cgc::round_to<T>(va[i]) + bias);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const long long row = row0 + a_r + (kThreads / kBK) * i;
        va[i] = a_ok ? cgc::to_f32(a[row * lda + k0 + a_k]) : 0.f;
      }
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

template <typename T, bool PRE, bool LIN>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const T* __restrict__ x12, const T* __restrict__ p, Lin<T> lin,
    const float* __restrict__ rnorm, const T* __restrict__ k12,
    const T* __restrict__ k3f, const float* __restrict__ cnst,
    const int* __restrict__ n_nodes, float* logits, int N, int F12, int C) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  __shared__ float s_rn[kBM];
  extern __shared__ float s_x3[];  // LIN: [kBM][F3]

  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long b = row0 / N;  // N % 128 == 0: a tile lies in one graph
  if (row0 - b * N >= n_nodes[b]) return;  // every row of the tile is padding
  const int col0 = blockIdx.x * kBN;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  if (PRE && t < kBM) s_rn[t] = rnorm[row0 + t];
  if (LIN) {
    for (int e = t; e < kBM * lin.F3; e += kThreads)
      s_x3[e] = cgc::to_f32(lin.x3[row0 * lin.F3 + e]);
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gemm_part<T, false, false>(x12, F12, k12, C, F12, row0, col0, C, s_rn,
                             s_x3, lin, As, Bs, acc);
  gemm_part<T, PRE, LIN>(p, C, k3f, C, C, row0, col0, C, s_rn, s_x3, lin, As,
                         Bs, acc);

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

// logits and s may alias (f32, c_out == C): no __restrict__ on them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_kernel(const float* logits, const int* __restrict__ n_nodes, T* s,
                   int N, long long rows, int C, int c_out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long b = row / N;
  T* sr = s + row * c_out;
  for (int c = C + lane; c < c_out; c += 32) sr[c] = cgc::from_f32<T>(0.f);
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

struct HeadArgs {
  const void* x12;
  const void* p;    // raw p (B4), h3a (B6); null for B9a
  const void* x3;   // B9a only
  const void* kc3;
  const void* b3;
  const void* k12;
  const void* k3f;
  const float* cnst;
  const int* n_nodes;
  float* rnorm;     // [B*N] scratch (B4, B9a); null for B6
  float* logits;    // [B*N, C] f32 (may be s itself: f32, c_out == C)
  void* s;          // [B*N, c_out]
  int B, N, F12, F3, C, c_out;
};

// PRE: normalize on load (B4, B9a); LIN: p from x3 (B9a); else B6
template <typename T, bool PRE, bool LIN>
cudaError_t launch(const HeadArgs& a, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.N;
  if (rows == 0 || a.C == 0) return cudaGetLastError();
  const Lin<T> lin{static_cast<const T*>(a.x3), static_cast<const T*>(a.kc3),
                   static_cast<const T*>(a.b3), LIN ? a.F3 : 0};
  const unsigned warp_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (PRE) {
    const size_t smem = sizeof(float) * (kThreads / 32) * lin.F3;
    rnorm_kernel<T, LIN><<<warp_blocks, kThreads, smem, st>>>(
        static_cast<const T*>(a.p), lin, a.rnorm, rows, a.C);
  }
  const size_t gsmem = sizeof(float) * kBM * lin.F3;
  if (LIN) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<T, PRE, LIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(gsmem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.C + kBN - 1) / kBN, static_cast<unsigned>(rows / kBM));
  gemm_kernel<T, PRE, LIN><<<grid, kThreads, gsmem, st>>>(
      static_cast<const T*>(a.x12), static_cast<const T*>(a.p), lin, a.rnorm,
      static_cast<const T*>(a.k12), static_cast<const T*>(a.k3f), a.cnst,
      a.n_nodes, a.logits, a.N, a.F12, a.C);
  softmax_kernel<T><<<warp_blocks, kThreads, 0, st>>>(
      a.logits, a.n_nodes, static_cast<T*>(a.s), a.N, rows, a.C, a.c_out);
  return cudaGetLastError();
}

template <bool PRE, bool LIN>
int dispatch(const HeadArgs& a, int dtype, int device, void* stream) {
  if (a.c_out < a.C || (LIN && a.F3 <= 0)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cgc::kF32:
      return launch<float, PRE, LIN>(a, st);
    case cgc::kBF16:
      return launch<__nv_bfloat16, PRE, LIN>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// B4: x12, raw p, K12, K3f, const, n_nodes; rnorm scratch [B*N] f32; S
// c_out >= C columns wide
extern "C" int cgc_assign_head_pre(const void* x12, const void* p,
                                   const void* k12, const void* k3f,
                                   const void* cnst, const void* n_nodes,
                                   void* rnorm, void* logits, void* s, int B,
                                   int N, int F12, int C, int c_out,
                                   int dtype, int device, void* stream) {
  const HeadArgs a{x12, p, nullptr, nullptr, nullptr, k12, k3f,
                   static_cast<const float*>(cnst),
                   static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), static_cast<float*>(logits), s,
                   B, N, F12, 0, C, c_out};
  return dispatch<true, false>(a, dtype, device, stream);
}

// B6: x12, h3a, K12, K3f, const, n_nodes; rnorm is not read (null), so the
// two entries share one argument list
extern "C" int cgc_assign_head(const void* x12, const void* h3a,
                               const void* k12, const void* k3f,
                               const void* cnst, const void* n_nodes,
                               void* rnorm, void* logits, void* s, int B,
                               int N, int F12, int C, int c_out, int dtype,
                               int device, void* stream) {
  const HeadArgs a{x12, h3a, nullptr, nullptr, nullptr, k12, k3f,
                   static_cast<const float*>(cnst),
                   static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), static_cast<float*>(logits), s,
                   B, N, F12, 0, C, c_out};
  return dispatch<false, false>(a, dtype, device, stream);
}

// B9a: x12, x3 [B*N, F3], kc3 [F3, C], b3 [C], K12, K3f, const, n_nodes;
// rnorm scratch [B*N] f32; S [B*N, C]
extern "C" int cgc_assign_head_pre_lin(
    const void* x12, const void* x3, const void* kc3, const void* b3,
    const void* k12, const void* k3f, const void* cnst, const void* n_nodes,
    void* rnorm, void* logits, void* s, int B, int N, int F12, int F3, int C,
    int dtype, int device, void* stream) {
  const HeadArgs a{x12, nullptr, x3, kc3, b3, k12, k3f,
                   static_cast<const float*>(cnst),
                   static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), static_cast<float*>(logits), s,
                   B, N, F12, F3, C, C};
  return dispatch<true, true>(a, dtype, device, stream);
}
