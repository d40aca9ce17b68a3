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
// F12=40, C=1140; 2*N*C*(F12+C) = 270 GFLOP at a 100k-nuclei slide): 0.27
// ms on the bf16 tensor cores, 4.0 ms on the f32 CUDA cores. The 1140-wide
// f32 logits row of a 128-row tile does not fit in shared memory, so the
// work is three launches on one stream (two for B6):
//   1. the row norm (B4, B9a; its own C entry, which the wrapper calls
//      before it pads the weights, so the card works meanwhile): f32 sum of
//      squares of the row -> rnorm scratch. B9a forms p here too — the row's norm needs all of it, and
//      storing p would be the [N, C] tensor B9a exists to avoid, so B9a
//      computes p twice (here and in the product): 2*N*C*F3 more operations
//      (~5 GFLOP at 100k nuclei, F3 = 20). rnorm_kernel: one warp per row
//      through common.cuh's row_rnorm, the routine of B3's statistics too,
//      so the statistics and the head form the same h (B4: p read in the
//      widest vectors the row width and base allow; B9a in f32: p formed
//      per column from x3 staged in shared memory and kc3, as f32 B9b
//      forms it);
//      rnorm_lin_tc_kernel (B9a in bf16): p by mma.sync through
//      tc.cuh's lin_p_mma, the routine of the product too, so norm and
//      product read the same p, and the norm by tc.cuh's lin_rnorm, the
//      routine of B9b's statistics too;
//   2. the product, logits + const -> an f32 buffer; tiles wholly past
//      n_nodes are skipped.
//      bf16: gemm_tc_kernel on the tensor cores. A 128 x 192 output tile per
//      thread block (1152 = 6 x 192 covers C = 1140 with 12 masked
//      columns), two warpgroups of 64 rows issuing wgmma m64n192k16 (each
//      k-step's as soon as its A fragment is formed), K in stages of 64
//      through a ring of 4 cp.async stages. The B operand is
//      [K12 ; K3f] as one zero-padded bf16 copy the wrapper makes per call
//      and the entry checks the shape of (K12 in a 64-row segment, K3f in ceil(C/64)*64 rows, ceil(C/192)*192
//      columns: every row 16-byte aligned, every tile in bounds), laid into
//      128-byte-swizzled tiles. The A operand is formed on load in
//      registers, as wgmma's register operand, so nothing [N, C]-wide is
//      written: x12 as it is; B4: raw p tiles land in shared memory and
//      become h = round(relu(p) * rnorm) in registers; B6: h3a as it is;
//      B9a: p = round(round(x3 . kc3[:, c]) + b3[c]) is itself formed on
//      the tensor cores — the x3 rows [128 x F3 padded to 32] times the
//      stage's slice of a transposed, padded kc3 by mma.sync m16n8k16, each
//      warp for its own 16 rows, whose f32 accumulator fragment is rounded
//      into the A fragment of the main product (FlashAttention's reuse of
//      P), instead of the 9x SIMT recomputation. p's rows are 2,280 bytes
//      at C = 1140 (8-byte aligned): the A tiles arrive by the widest
//      cp.async the widths and base addresses allow (8 bytes there).
//      f32: gemm_kernel, a 128x128 output tile per block, k-steps of 32
//      over x12 @ K12 and then h @ K3f (B4: h formed on load from p and the
//      tile's rnorm; B9a: p itself formed on load from the tile's x3 rows,
//      staged in shared memory, and a kc3 column held in registers; B6: h3a
//      as it is), 8x8 f32 register tile per thread, each thread's global
//      loads of a k-step issued together into registers (f32 on the tensor
//      cores would mean TF32, which the f32 tolerances do not allow);
//   3. the softmax, one warp per row, S in T, zeros past C and on rows past
//      n_nodes, in place in f32 when c_out == C (each lane reads an element
//      before it writes it). softmax_rows_kernel (C <= 1536): the row read
//      once into registers; softmax_kernel (wider rows): max / sum /
//      normalize passes over the f32 logits. Both add in one order.
// S^T is not written: the caller takes S.transpose(1, 2) as a view.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

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

// One warp per row: the row norm by cgc::row_rnorm, B3's routine — p read
// in vectors of E (cgc::row_vec: the width B3 reads the same p in), or
// (LIN, E = 1) p formed per column from the row's x3 by cgc::lin_p.
template <typename T, int E, bool LIN>
__global__ void __launch_bounds__(kThreads)
    rnorm_kernel(const T* __restrict__ p, Lin<T> lin,
                 float* __restrict__ rnorm, long long rows, int C) {
  extern __shared__ float s_x3[];  // LIN: [kThreads / 32][F3]
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (row >= rows) return;
  float rn;
  if constexpr (LIN) {
    float* xs = s_x3 + warp * lin.F3;
    for (int k = lane; k < lin.F3; k += 32)
      xs[k] = cgc::to_f32(lin.x3[row * lin.F3 + k]);
    __syncwarp();
    rn = cgc::row_rnorm<1>(C, lane, [&](int c, float(&x)[1]) {
      x[0] = cgc::lin_p(xs, lin.kc3, lin.b3, lin.F3, C, c);
    });
  } else {
    const T* pr = p + row * C;
    rn = cgc::row_rnorm<E>(C / E, lane, [&](int v, float(&x)[E]) {
      cgc::load_vec<T, E>(x, pr + v * E);
    });
  }
  if (lane == 0) rnorm[row] = rn;
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

// ---- bf16 product on the tensor cores ----

using bf16 = __nv_bfloat16;
constexpr int kHK = 64;                         // K rows per pipeline stage
constexpr int kHStages = 4;                     // cp.async stages (a fifth
constexpr int kHAhead = kHStages - 1;           //   made B4 slower), loaded
                                                //   this far ahead
constexpr uint32_t kWAtom = kHK * 128;          // [64 K x 64 columns]: 8 KB
constexpr uint32_t kWStage = 3 * kWAtom;        // [64 x 192] of the weights
constexpr int kAStride = kHK * 2 + 16;          // A row: 144 bytes, so the
constexpr uint32_t kAStage = kBM * kAStride;    //   fragment reads of 8 rows
                                                //   hit 8 bank groups
using cgc::tc::kF3Pad;                          // B9a: x3 width, 2 k-steps
using cgc::tc::kLStride;                        // kc3^T row: 80 bytes
constexpr uint32_t kLStage = kHK * kLStride;    // [64 x 32] slice of kc3^T
// a multiple of 1024, so the atoms of every stage stay aligned
template <bool LIN>
__host__ __device__ constexpr uint32_t head_stage() {
  return kWStage + kAStage + (LIN ? kLStage : 0);
}
// after the stages: rnorm of the tile's rows, then (B9a) its x3 rows and
// b3 in f32
constexpr uint32_t kRnBytes = kBM * sizeof(float);
constexpr uint32_t kX3Bytes = kBM * kLStride;
__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
template <bool LIN>
size_t head_smem(int C) {
  return kHStages * head_stage<LIN>() + kRnBytes +
         (LIN ? kX3Bytes + sizeof(float) * round_up(C, kHK) : 0) + 1024;
}

// logits[row0 : row0+128, col0 : col0+192] = [x12 | A3] @ w + const, w the
// padded [K12 ; K3f] ([Kp x Cp]: K12 in rows [0, F12) of the first K12p, K3f
// in rows [K12p, K12p + C)); A3 = h from raw p (PRE), h3a (neither), or h
// from p formed from x3 and kc3t ([Kp - K12p x 32], kc3^T zero-padded) and
// b3 (LIN). x12 and p rows arrive VEC bytes at a time.
template <bool PRE, bool LIN, int VEC>
__global__ void __launch_bounds__(kThreads, 1) gemm_tc_kernel(
    const bf16* __restrict__ x12, const bf16* __restrict__ p,
    const bf16* __restrict__ x3, const bf16* __restrict__ kc3t,
    const bf16* __restrict__ b3, const float* __restrict__ rnorm,
    const bf16* __restrict__ w, const float* __restrict__ cnst,
    const int* __restrict__ n_nodes, float* __restrict__ logits, int N,
    int F12, int F3, int C) {
  using namespace cgc::tc;
  constexpr uint32_t SB = head_stage<LIN>();
  const int K12p = round_up(F12, kHK);
  const int nk = (K12p + round_up(C, kHK)) / kHK;
  const int Cp = round_up(C, kN);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  float* s_rn = reinterpret_cast<float*>(smem + kHStages * SB);
  bf16* s_x3 = reinterpret_cast<bf16*>(smem + kHStages * SB + kRnBytes);
  float* s_b3 = reinterpret_cast<float*>(smem + kHStages * SB + kRnBytes +
                                         kX3Bytes);

  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long b = row0 / N;  // N % 128 == 0: a tile lies in one graph
  if (row0 - b * N >= n_nodes[b]) return;  // every row of the tile is padding
  const int col0 = blockIdx.x * kN;
  const int t = threadIdx.x;
  if (PRE && t < kBM) s_rn[t] = rnorm[row0 + t];
  if (LIN) {
    for (int e = t; e < kBM * kF3Pad; e += kThreads) {
      const int row = e / kF3Pad, k = e % kF3Pad;
      s_x3[row * (kLStride / 2) + k] =
          k < F3 ? x3[(row0 + row) * F3 + k] : __float2bfloat16(0.f);
    }
    for (int c = t; c < round_up(C, kHK); c += kThreads)
      s_b3[c] = c < C ? cgc::to_f32(b3[c]) : 0.f;
  }

  // A tile: 128 rows x 64 columns from column c0 of a [rows x width] array
  auto load_a = [&](uint32_t dst, const bf16* src, int width, int c0) {
    constexpr int EL = VEC / 2, PER_ROW = kHK / EL;
#pragma unroll 4
    for (int e = t; e < kBM * PER_ROW; e += kThreads) {
      const int row = e / PER_ROW, col = (e % PER_ROW) * EL;
      const bool ok = c0 + col < width;
      cp_async<VEC>(dst + row * kAStride + col * 2,
                    ok ? src + (row0 + row) * width + c0 + col : src, ok);
    }
  };
  // stage kt: rows kt*64.. of w (swizzled), and the A tile or kc3t slice
  auto load = [&](int kt) {
    const uint32_t st = sbase + (kt % kHStages) * SB;
    const int k0 = kt * kHK;
#pragma unroll
    for (int e = t; e < kHK * (kN / 8); e += kThreads) {
      const int k = e / (kN / 8), col = (e % (kN / 8)) * 8;
      cp_async<16>(st + swz_offset(k, col, kWAtom),
                   w + static_cast<long long>(k0 + k) * Cp + col0 + col, true);
    }
    if (k0 < K12p) {
      load_a(st + kWStage, x12, F12, k0);
    } else if (!LIN) {
      load_a(st + kWStage, p, C, k0 - K12p);
    } else {
      for (int e = t; e < kHK * (kF3Pad / 8); e += kThreads) {
        const int row = e / (kF3Pad / 8), q = e % (kF3Pad / 8);
        cp_async<16>(st + kWStage + kAStage + row * kLStride + q * 16,
                     kc3t + static_cast<long long>(k0 - K12p + row) * kF3Pad +
                         q * 8,
                     true);
      }
    }
  };

  float d[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) d[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kHAhead; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  __syncthreads();  // s_rn, s_x3
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  const int ra = (t / 128) * 64 + ((t / 32) % 4) * 16 + g;  // rows ra, ra+8
  const float rn0 = PRE ? s_rn[ra] : 1.f, rn1 = PRE ? s_rn[ra + 8] : 1.f;
  uint32_t xf[2][4];  // B9a: the x3 rows as mma.sync A fragments
  if (LIN) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const bf16* r0 = s_x3 + ra * (kLStride / 2) + 16 * kk + 2 * tq;
      const bf16* r1 = r0 + 8 * (kLStride / 2);
      xf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
      xf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
      xf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      xf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kHAhead - 1>();
    __syncthreads();  // stage kt landed; every thread is done with kt-1
    if (kt + kHAhead < nk) load(kt + kHAhead);
    cp_async_commit();
    const uint32_t st = (kt % kHStages) * SB;
    const int k0 = kt * kHK;
    const bool lin_part = LIN && k0 >= K12p;
    const bf16* ls =
        reinterpret_cast<const bf16*>(smem + st + kWStage + kAStage);
    const bf16* a0 = reinterpret_cast<const bf16*>(
        smem + st + kWStage + ra * kAStride);
    const bf16* a1 = a0 + 8 * (kAStride / 2);
    // each k-step's product is issued as soon as its A fragment is formed,
    // so forming the next fragment overlaps it
    uint32_t af[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (lin_part) {
        // p for the warp's 16 rows x 16 columns of C, 8 at a time
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jn = 2 * ks + half;
          const int col = k0 - K12p + 8 * jn + 2 * tq;
          float pv[4], hv[4];
          lin_p_mma(pv, xf,
                    ls + (8 * jn + g) * (kLStride / 2) + 2 * tq,
                    s_b3[col], s_b3[col + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            hv[i] = fmaxf(pv[i], 0.f) * (i < 2 ? rn0 : rn1);
          af[ks][half * 2] = pack_bf16(hv[0], hv[1]);
          af[ks][half * 2 + 1] = pack_bf16(hv[2], hv[3]);
        }
      } else {
        const int k = ks * 16 + 2 * tq;
        uint32_t v[4] = {*reinterpret_cast<const uint32_t*>(a0 + k),
                         *reinterpret_cast<const uint32_t*>(a1 + k),
                         *reinterpret_cast<const uint32_t*>(a0 + k + 8),
                         *reinterpret_cast<const uint32_t*>(a1 + k + 8)};
        if (PRE && k0 >= K12p) {  // h = round(relu(p) * rnorm) on load
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = unpack_bf16(v[i]);
            const float rn = i % 2 ? rn1 : rn0;
            v[i] = pack_bf16(fmaxf(f.x, 0.f) * rn, fmaxf(f.y, 0.f) * rn);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) af[ks][i] = v[i];
      }
      wgmma_fence();
      wgmma_m64n192k16_rs(
          d, af[ks], desc_mn_sw128(sbase + st + ks * 16 * 128, kWAtom, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + ra + 8 * h;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * tq;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (C % 2 == 0 && col < C) {  // an even C: 8-byte aligned pairs
        *reinterpret_cast<float2*>(logits + row * C + col) =
            make_float2(v0 + cnst[col], v1 + cnst[col + 1]);
      } else {
        if (col < C) logits[row * C + col] = v0 + cnst[col];
        if (col + 1 < C) logits[row * C + col + 1] = v1 + cnst[col + 1];
      }
    }
  }
}

// B9a's row norm on the tensor cores: p for a tile of 128 rows x all of C
// by mma.sync through lin_p_mma (tc.cuh), as gemm_tc_kernel forms it, so
// the norm and the product read the same p; the norm by tc.cuh's lin_rnorm,
// B9b's routine too. kc3t ([round_up(C, 64), 32], kc3^T padded) is staged
// in shared memory.
__global__ void __launch_bounds__(kThreads) rnorm_lin_tc_kernel(
    const bf16* __restrict__ x3, const bf16* __restrict__ kc3t,
    const bf16* __restrict__ b3, const int* __restrict__ n_nodes,
    float* __restrict__ rnorm, int N, int F3, int C) {
  using namespace cgc::tc;
  extern __shared__ __align__(16) uint8_t smem_k[];
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const long long b = row0 / N;
  if (row0 - b * N >= n_nodes[b]) return;  // every row of the tile is padding
  const int Kc = round_up(C, kHK);
  const int t = threadIdx.x;
  for (int e = t; e < Kc * (kF3Pad / 8); e += kThreads) {
    const int row = e / (kF3Pad / 8), q = e % (kF3Pad / 8);
    cp_async<16>(smem_u32(smem_k) + row * kLStride + q * 16,
                 kc3t + static_cast<long long>(row) * kF3Pad + q * 8, true);
  }
  cp_async_commit();
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  const long long ra = row0 + (t / 32) * 16 + g;  // rows ra, ra + 8
  uint32_t xf[2][4];
  lin_x3_frags(xf, x3, ra, F3, tq);
  cp_async_wait<0>();
  __syncthreads();
  float rn0, rn1;
  lin_rnorm(rn0, rn1, xf, reinterpret_cast<const bf16*>(smem_k),
            kLStride / 2, b3, C, lane);
  if (tq == 0) {
    rnorm[ra] = rn0;
    rnorm[ra + 8] = rn1;
  }
}

// Test-only (tests/test_torch_cuda.py, scripts/slide_hold_probe.py): p
// [rows, C] in bf16 as lin_p_mma forms it for B9a and B9b, and each row's
// norm as lin_rnorm forms it (rnorm [rows] f32), one warp per 16 rows, kc3t
// read from device memory. No path of the package calls it.
__global__ void __launch_bounds__(kThreads)
    lin_p_probe_kernel(const bf16* __restrict__ x3,
                       const bf16* __restrict__ kc3t,
                       const bf16* __restrict__ b3, bf16* __restrict__ p,
                       float* __restrict__ rnorm, int F3, int C) {
  using namespace cgc::tc;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const long long ra =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) +
       threadIdx.x / 32) * 16 + g;
  uint32_t xf[2][4];
  lin_x3_frags(xf, x3, ra, F3, tq);
  for (int jn = 0; jn < round_up(C, kHK) / 8; ++jn) {
    const int col = 8 * jn + 2 * tq;
    float v[4];
    lin_p_mma(v, xf, kc3t + static_cast<long long>(8 * jn + g) * kF3Pad +
                         2 * tq,
              col < C ? cgc::to_f32(b3[col]) : 0.f,
              col + 1 < C ? cgc::to_f32(b3[col + 1]) : 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cc = col + i % 2;
      if (cc < C) p[(ra + 8 * (i / 2)) * C + cc] = __float2bfloat16(v[i]);
    }
  }
  float rn0, rn1;
  lin_rnorm(rn0, rn1, xf, kc3t, kF3Pad, b3, C, lane);
  if (tq == 0) {
    rnorm[ra] = rn0;
    rnorm[ra + 8] = rn1;
  }
}

// The softmax with the row in registers: one warp per row, one read of the
// f32 logits (lane l holds columns l, l + 32, ...), then max, sum and the
// normalized row written in T; rows past n_nodes and columns C..c_out-1
// exactly 0. The same additions in the same order as softmax_kernel, so the
// same bits, with one read of the row instead of three and one expf per
// element instead of two. For C <= 32 * kSoftPer. logits and s may alias
// (f32, c_out == C): a lane writes only the columns it has already read.
constexpr int kSoftPer = 48;
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_rows_kernel(const float* logits, const int* __restrict__ n_nodes,
                        T* s, int N, long long rows, int C, int c_out) {
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
  float v[kSoftPer];
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int i = 0; i < kSoftPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? lr[c] : __int_as_float(0xff800000);
    m = fmaxf(m, v[i]);
  }
  m = cgc::warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kSoftPer; ++i) {
    v[i] = lane + 32 * i < C ? expf(v[i] - m) : 0.f;
    sum += v[i];
  }
  sum = cgc::warp_sum(sum);
#pragma unroll
  for (int i = 0; i < kSoftPer; ++i) {
    const int c = lane + 32 * i;
    if (c < C) sr[c] = cgc::from_f32<T>(v[i] / sum);
  }
}

// The softmax of rows wider than 32 * kSoftPer: max / sum / normalize
// passes over the row. logits and s may alias (f32, c_out == C): no
// __restrict__ on them.
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
  const void* wpad;  // bf16: [K12 ; K3f] padded (see gemm_tc_kernel)
  const void* kc3t;  // bf16 B9a: kc3^T padded to [ceil(C/64)*64, 32]
  const float* cnst;
  const int* n_nodes;
  float* rnorm;     // [B*N] scratch (B4, B9a); null for B6
  float* logits;    // [B*N, C] f32 (may be s itself: f32, c_out == C)
  void* s;          // [B*N, c_out]
  int B, N, F12, F3, C, c_out;
  int w_rows, w_cols;    // wpad's shape (bf16)
  int kt_rows, kt_cols;  // kc3t's shape (bf16 B9a)
};

// The padded copies the bf16 kernels are tiled for, which the wrappers
// build (ops/assign_head.py: pad_head_weights, pad_lin_kernel): wpad is
// [round_up(F12, kHK) + round_up(C, kHK), round_up(C, kN)] with K12 in rows
// [0, F12) and K3f from row round_up(F12, kHK); kc3t is [round_up(C, kHK),
// kF3Pad]. The entries take both shapes and refuse any other.
bool wpad_ok(const HeadArgs& a) {
  return a.wpad != nullptr &&
         a.w_rows == round_up(a.F12, kHK) + round_up(a.C, kHK) &&
         a.w_cols == round_up(a.C, cgc::tc::kN);
}
bool kc3t_ok(const HeadArgs& a) {
  return a.kc3t != nullptr && a.F3 <= kF3Pad &&
         a.kt_rows == round_up(a.C, kHK) && a.kt_cols == kF3Pad;
}

template <bool PRE, bool LIN, int VEC>
cudaError_t launch_tc_gemm(const HeadArgs& a, cudaStream_t st) {
  auto kern = gemm_tc_kernel<PRE, LIN, VEC>;
  const size_t smem = head_smem<LIN>(a.C);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.B) * a.N;
  const dim3 grid(round_up(a.C, cgc::tc::kN) / cgc::tc::kN,
                  static_cast<unsigned>(rows / kBM));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(a.x12), static_cast<const bf16*>(a.p),
      static_cast<const bf16*>(a.x3), static_cast<const bf16*>(a.kc3t),
      static_cast<const bf16*>(a.b3), a.rnorm,
      static_cast<const bf16*>(a.wpad), a.cnst, a.n_nodes, a.logits, a.N,
      a.F12, LIN ? a.F3 : 0, a.C);
  return cudaGetLastError();
}

// the bf16 product: the widest copy of x12's and p's rows (16, 8 or 4
// bytes) that their widths and base addresses allow
template <bool PRE, bool LIN>
cudaError_t gemm_bf16(const HeadArgs& a, cudaStream_t st) {
  if (!wpad_ok(a) || (LIN && !kc3t_ok(a))) return cudaErrorInvalidValue;
  int vec = cgc::tc::copy_width(a.F12, a.x12);
  if (!LIN) vec = std::min(vec, cgc::tc::copy_width(a.C, a.p));
  switch (vec) {
    case 16:
      return launch_tc_gemm<PRE, LIN, 16>(a, st);
    case 8:
      return launch_tc_gemm<PRE, LIN, 8>(a, st);
    case 4:
      return launch_tc_gemm<PRE, LIN, 4>(a, st);
    default:
      return cudaErrorMisalignedAddress;
  }
}

// B9a's row norm on the tensor cores (kc3t staged whole in shared memory)
cudaError_t rnorm_lin_tc(const HeadArgs& a, cudaStream_t st) {
  if (!kc3t_ok(a)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(round_up(a.C, kHK)) * kLStride;
  cudaError_t err = cudaFuncSetAttribute(
      rnorm_lin_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.B) * a.N;
  rnorm_lin_tc_kernel<<<static_cast<unsigned>(rows / kBM), kThreads, smem,
                        st>>>(
      static_cast<const bf16*>(a.x3), static_cast<const bf16*>(a.kc3t),
      static_cast<const bf16*>(a.b3), a.n_nodes, a.rnorm, a.N, a.F3, a.C);
  return cudaGetLastError();
}

template <typename T, bool PRE, bool LIN>
cudaError_t gemm_simt(const HeadArgs& a, const Lin<T>& lin, cudaStream_t st) {
  if (a.k12 == nullptr || a.k3f == nullptr || (LIN && a.kc3 == nullptr))
    return cudaErrorInvalidValue;
  const size_t gsmem = sizeof(float) * kBM * lin.F3;
  if (LIN) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<T, PRE, LIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(gsmem));
    if (err != cudaSuccess) return err;
  }
  const long long rows = static_cast<long long>(a.B) * a.N;
  const dim3 grid((a.C + kBN - 1) / kBN, static_cast<unsigned>(rows / kBM));
  gemm_kernel<T, PRE, LIN><<<grid, kThreads, gsmem, st>>>(
      static_cast<const T*>(a.x12), static_cast<const T*>(a.p), lin, a.rnorm,
      static_cast<const T*>(a.k12), static_cast<const T*>(a.k3f), a.cnst,
      a.n_nodes, a.logits, a.N, a.F12, a.C);
  return cudaGetLastError();
}

// The row norm of B4 and B9a, a launch of its own (the wrapper issues it
// before it pads the weights, so the card works while the host does)
template <typename T, bool LIN>
cudaError_t launch_rnorm(const HeadArgs& a, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.N;
  if (rows == 0 || a.C == 0) return cudaGetLastError();
  if constexpr (std::is_same<T, bf16>::value && LIN) {
    return rnorm_lin_tc(a, st);
  } else {
    if (LIN && a.kc3 == nullptr) return cudaErrorInvalidValue;
    const Lin<T> lin{static_cast<const T*>(a.x3),
                     static_cast<const T*>(a.kc3),
                     static_cast<const T*>(a.b3), LIN ? a.F3 : 0};
    const unsigned warp_blocks =
        static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
    const size_t smem = sizeof(float) * (kThreads / 32) * lin.F3;
    auto p = static_cast<const T*>(a.p);
    if constexpr (LIN) {
      rnorm_kernel<T, 1, true><<<warp_blocks, kThreads, smem, st>>>(
          p, lin, a.rnorm, rows, a.C);
    } else {
      cudaError_t err = cgc::with_vec<T>(cgc::row_vec<T>(a.C, p),
                                         [&](auto e) {
        rnorm_kernel<T, decltype(e)::value, false>
            <<<warp_blocks, kThreads, 0, st>>>(p, lin, a.rnorm, rows, a.C);
        return cudaSuccess;
      });
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  }
}

// The product and the softmax (PRE: h from p and the row norm, B4; LIN: p
// from x3, B9a; else B6). bf16 takes the tensor-core product, f32 the SIMT
// one (a dispatch on type).
template <typename T, bool PRE, bool LIN>
cudaError_t launch(const HeadArgs& a, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.N;
  if (rows == 0 || a.C == 0) return cudaGetLastError();
  const Lin<T> lin{static_cast<const T*>(a.x3), static_cast<const T*>(a.kc3),
                   static_cast<const T*>(a.b3), LIN ? a.F3 : 0};
  const unsigned warp_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  constexpr bool kBF16 = std::is_same<T, bf16>::value;
  cudaError_t err;
  if constexpr (kBF16)
    err = gemm_bf16<PRE, LIN>(a, st);
  else
    err = gemm_simt<T, PRE, LIN>(a, lin, st);
  if (err != cudaSuccess) return err;
  if (a.C <= 32 * kSoftPer)
    softmax_rows_kernel<T><<<warp_blocks, kThreads, 0, st>>>(
        a.logits, a.n_nodes, static_cast<T*>(a.s), a.N, rows, a.C, a.c_out);
  else
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

// The row norm of B4 (raw p) or B9a (p null: x3, b3 and kc3 in f32, kc3t
// [kt_rows, kt_cols] in bf16) -> rnorm scratch [B*N] f32;
// cgc_assign_head_pre and cgc_assign_head_pre_lin read it.
extern "C" int cgc_assign_head_rnorm(const void* p, const void* x3,
                                     const void* kc3, const void* kc3t,
                                     const void* b3, const void* n_nodes,
                                     void* rnorm, int B, int N, int F3, int C,
                                     int kt_rows, int kt_cols, int dtype,
                                     int device, void* stream) {
  const bool lin = p == nullptr;
  if (lin && F3 <= 0) return cudaErrorInvalidValue;
  const HeadArgs a{nullptr, p, x3, kc3, b3, nullptr, nullptr, nullptr, kc3t,
                   nullptr, static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), nullptr, nullptr,
                   B, N, 0, F3, C, C, 0, 0, kt_rows, kt_cols};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case cgc::kF32:
      return lin ? launch_rnorm<float, true>(a, st)
                 : launch_rnorm<float, false>(a, st);
    case cgc::kBF16:
      return lin ? launch_rnorm<bf16, true>(a, st)
                 : launch_rnorm<bf16, false>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// B4: x12, raw p, K12 and K3f (f32; null in bf16), or their padded copy
// wpad [w_rows, w_cols] (bf16; null in f32), const, n_nodes; rnorm [B*N] f32
// from cgc_assign_head_rnorm; S c_out >= C columns wide
extern "C" int cgc_assign_head_pre(const void* x12, const void* p,
                                   const void* k12, const void* k3f,
                                   const void* wpad, const void* cnst,
                                   const void* n_nodes, void* rnorm,
                                   void* logits, void* s, int B, int N,
                                   int F12, int C, int c_out, int w_rows,
                                   int w_cols, int dtype, int device,
                                   void* stream) {
  const HeadArgs a{x12, p, nullptr, nullptr, nullptr, k12, k3f, wpad, nullptr,
                   static_cast<const float*>(cnst),
                   static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), static_cast<float*>(logits), s,
                   B, N, F12, 0, C, c_out, w_rows, w_cols, 0, 0};
  return dispatch<true, false>(a, dtype, device, stream);
}

// B6: x12, h3a, K12, K3f / wpad, const, n_nodes; rnorm is not read (null),
// so the two entries share one argument list
extern "C" int cgc_assign_head(const void* x12, const void* h3a,
                               const void* k12, const void* k3f,
                               const void* wpad, const void* cnst,
                               const void* n_nodes, void* rnorm, void* logits,
                               void* s, int B, int N, int F12, int C,
                               int c_out, int w_rows, int w_cols, int dtype,
                               int device, void* stream) {
  const HeadArgs a{x12, h3a, nullptr, nullptr, nullptr, k12, k3f, wpad,
                   nullptr, static_cast<const float*>(cnst),
                   static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), static_cast<float*>(logits), s,
                   B, N, F12, 0, C, c_out, w_rows, w_cols, 0, 0};
  return dispatch<false, false>(a, dtype, device, stream);
}

// Test-only: p [rows, C] bf16 and rnorm [rows] f32 from x3 [rows, F3],
// kc3t ([kt_rows, kt_cols] = [round_up(C, 64), 32], pad_lin_kernel) and b3
// through lin_p_mma and lin_rnorm, the routines B9a and B9b form p and its
// row norm with; rows a multiple of 128. The package never calls it.
extern "C" int cgc_lin_p_probe(const void* x3, const void* kc3t,
                               const void* b3, void* p, void* rnorm, int rows,
                               int F3, int C, int kt_rows, int kt_cols,
                               int device, void* stream) {
  HeadArgs a{};
  a.kc3t = kc3t;
  a.F3 = F3;
  a.C = C;
  a.kt_rows = kt_rows;
  a.kt_cols = kt_cols;
  if (rows % kBM || F3 <= 0 || !kc3t_ok(a)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows > 0 && C > 0)
    lin_p_probe_kernel<<<rows / kBM, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x3), static_cast<const bf16*>(kc3t),
        static_cast<const bf16*>(b3), static_cast<bf16*>(p),
        static_cast<float*>(rnorm), F3, C);
  return cudaGetLastError();
}

// B9a: x12, x3 [B*N, F3], b3 [C]; kc3 [F3, C], K12, K3f (f32; null in
// bf16) or kc3t [kt_rows, kt_cols], wpad [w_rows, w_cols] (bf16; null in
// f32); const, n_nodes; rnorm [B*N] f32 from cgc_assign_head_rnorm; S
// [B*N, C]
extern "C" int cgc_assign_head_pre_lin(
    const void* x12, const void* x3, const void* kc3, const void* b3,
    const void* kc3t, const void* k12, const void* k3f, const void* wpad,
    const void* cnst, const void* n_nodes, void* rnorm, void* logits, void* s,
    int B, int N, int F12, int F3, int C, int w_rows, int w_cols,
    int kt_rows, int kt_cols, int dtype, int device, void* stream) {
  const HeadArgs a{x12, nullptr, x3, kc3, b3, k12, k3f, wpad, kc3t,
                   static_cast<const float*>(cnst),
                   static_cast<const int*>(n_nodes),
                   static_cast<float*>(rnorm), static_cast<float*>(logits), s,
                   B, N, F12, F3, C, C, w_rows, w_cols, kt_rows, kt_cols};
  return dispatch<true, true>(a, dtype, device, stream);
}
