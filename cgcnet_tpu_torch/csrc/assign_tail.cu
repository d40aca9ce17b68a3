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
// (p of the real rows read once: 228 MB in bf16 at the slide's 100000 x
// 1140, ~0.068 ms; 91 MB in f32 at the patch's B=4, N=5760, ~0.027 ms).
// stats_kernel reads each real row once: the batch's real rows are cut
// into equal runs in flat order, one per warp of a grid of at most 256
// blocks (a function of the shape alone), and a warp streams its run
// through shared memory by cp.async, kStatsStages rows a warp, so two rows
// are in flight while one is summed (a bf16 row is little arithmetic for
// its bytes: without the overlap it does not stream), in the widest
// vectors the row width and base allow (8 bytes for bf16 at C = 1140, 16
// for f32; cgc::row_vec). Per row, the norm comes from common.cuh's
// row_rnorm over the staged copy — B4's rnorm_kernel calls the same
// routine in the same vectors, so B3's h is B4's, bit for bit — then each
// lane adds h and h^2 of its own columns (vector j * 32 + lane) into
// registers, 1280 columns a pass; wider rows (no configuration has them:
// the assign tail's C is int(max_num_nodes * 0.1), 1140 or 114) take a
// grid column per 1280 columns, each reading the whole row for its norm.
// Rows past n_nodes are neither read nor summed (they add exactly 0). A
// block's eight warps put their sums in slices of shared memory of their
// own, which all its threads add in warp order (half the columns at a
// time, in the space the rows were staged in), and write one [2, C]
// partial (2.3 MB at C = 1140); stats_reduce_kernel
// sums the partials, half a warp per 16 columns and 32 half-warps a block
// (~140 blocks at C = 1140), each over every 32nd partial with eight loads
// in flight, then the half-warps in order. No atomics: the same bits run
// to run.
//
// B9b replaces cgcnet_tpu/ops/pallas/assign_head.py: _stats_call_lin
// (_stats_kernel_lin): B3 with conv3's lin inside — p is never stored, each
// value is formed where it is used from the row's x3 and kc3 / b3: p =
// round_T(round_T(x3 . kc3[:,c]) + b3[c]). Bound: operations — the F3-term
// dot per element (2*N*C*F3, ~4.6 GFLOP at 100k nuclei, F3 = 20; the
// tensor cores' in bf16) and the row norm and sums on the f32 CUDA cores;
// x3 is read once (~4 MB in bf16).
//   bf16: stats_lin_tc_kernel, a block of four warps per 64-row tile. p is
//   formed on the tensor cores by tc.cuh's lin_p_mma (mma.sync m16n8k16 of
//   the x3 rows against a transposed, padded kc3, ops/assign_head.py
//   pad_lin_kernel) and the row norm by tc.cuh's lin_rnorm — B9a's
//   routines, so the statistics and the head see the same p and h, bit for
//   bit. Phase 1: warp w takes the norm of rows 16w .. 16w + 15 over all of
//   C. Phase 2 forms p again (2 x 4.6 GFLOP is nothing at the bf16 rate)
//   instead of keeping a [64, C] tile: warp w walks the 8-column tiles w,
//   w + 4, ... holding the x3 fragments of all four row groups in
//   registers, so each kc3^T fragment it reads serves 64 rows; each lane
//   sums h and h^2 of its two columns over its 8 rows, then the 8 lanes of
//   a column pair add by xor-shuffle, in a fixed order. kc3^T (74 KB at C =
//   1140) is read through L1 / L2, nothing C-wide sits in shared memory: any
//   C. F3 <= 32 (two k-steps of 16). Every tile writes its partial (zeros
//   past n_nodes), and B3's reduction sums them.
//   f32: B3's stats_kernel with the LIN switch: each row's p formed once,
//   column by column by cgc::lin_p's fmaf chain on the CUDA cores, in the
//   order of B9a f32's row norm (rnorm_kernel, the same row_rnorm), into
//   the warp's row copy in shared memory, and summed from there.
//
// B5 replaces cgcnet_tpu/ops/pallas/assign_head.py: _bwd_call (_bwd_kernel):
//   hs     = rmask * h
//   dh_tot = dh + rmask * (u + 2 * hs * w)
//   dp     = rmask * (p > 0) * rnorm * dh_tot - rnorm^2 * p * sum_c(dh_tot*hs)
// written in T. On a row past n_nodes hs = 0, so the row sum is 0 and dp is
// exactly 0 for any finite p and dh: those rows are written as zeros and
// not read. Bound: bytes (p and dh of the real rows read once, dp written
// once: 685 MB at the slide's 100352 x 1140 in bf16, ~0.20 ms). Each row's
// p and dh are read from device memory once, in vectors of E elements — the
// widest (up to 16 bytes) that the row width and every base address allow:
// 8 bytes for bf16 rows at C = 1140, 16 for f32 — then two passes over that
// copy: the first sums ||p||^2, sum((dh + u) relu(p)) and sum(w relu(p)^2)
// together (sum(dh_tot * hs) is rnorm times the second plus 2 rnorm^2 times
// the third, so no pass waits for rnorm alone), the second writes dp once,
// in the same vectors.
//   bf16 (an even C up to 12288): tail_bwd_staged_kernel, each warp walks
//   its rows with the copy in shared memory, two stages: the next row's
//   cp.async reads are in flight while this row is computed (a bf16 row is
//   half an f32 row's bytes for the same arithmetic, so the reads must
//   overlap it to stream at the memory's rate); a lane's u and w stay in
//   registers across its rows up to C = 1280, else are read through L1.
//   f32, and bf16 rows the staged kernel does not take (an odd C, rows
//   2-byte aligned only, or C above 12288): tail_bwd_kernel, any C. W
//   warps per row (W = 1 up to C = 1280, a power of two above, at most the
//   block's eight) hold up to 10240 columns of the copy in registers; the
//   columns past that (no configuration has them: the assign tail's C is
//   int(max_num_nodes * 0.1), 1140 or 114) are read in both passes, the
//   second time from L2. The row sums go through warp shuffles, then the
//   W warps' sums through shared memory in warp order; u and w through L1.

#include <algorithm>
#include <mutex>

#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using cgc::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Lift a kernel's dynamic shared-memory cap to the device's opt-in limit,
// once per device (a launch asks for what it needs below that).
template <auto Kernel>
cudaError_t allow_smem(int device) {
  static std::mutex mu;
  static uint64_t done = 0;  // a bit per device
  std::lock_guard<std::mutex> lock(mu);
  if (device < 64 && (done >> device & 1)) return cudaSuccess;
  int most;
  cudaError_t err = cudaDeviceGetAttribute(
      &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && device < 64) done |= uint64_t{1} << device;
  return err;
}

// The conv3 lin operands of B9b: x3 [rows, F3], kc3 [F3, C], b3 [C].
template <typename T>
struct Lin {
  const T* x3;
  const T* kc3;
  const T* b3;
  int F3;
};

// ---- B3, and B9b in f32 ----

constexpr int kStatsWarps = 8;
constexpr int kStatsThreads = 32 * kStatsWarps;
constexpr int kStatsPerLane = 40;  // columns a lane sums: 1280 a block pass
constexpr int kStatsBlocks = 256;  // the grid's most blocks (its partials)
constexpr int kStatsMinRows = 64;  // rows a block at the least
constexpr int kStatsStages = 3;    // a warp's staged rows, two in flight

// Real rows of graph b: n_nodes[b] within [0, N].
__device__ __forceinline__ int real_rows(const int* __restrict__ n_nodes,
                                         int b, int N) {
  return min(max(n_nodes[b], 0), N);
}

// A walk over the batch's real rows in flat order, from the i-th.
struct RealRows {
  int b, off;  // graph, row within it
  __device__ void start(const int* __restrict__ n_nodes, int B, int N,
                        long long i) {
    for (b = 0; b < B; ++b) {
      const int n = real_rows(n_nodes, b, N);
      if (i < n) break;
      i -= n;
    }
    off = static_cast<int>(i);
  }
  __device__ long long row(int N) const {
    return static_cast<long long>(b) * N + off;
  }
  __device__ void next(const int* __restrict__ n_nodes, int B, int N) {
    for (++off; b < B && off >= real_rows(n_nodes, b, N); ++b) off = 0;
  }
};

// Per block (blockIdx.x, column chunk blockIdx.y): its warps' column sums
// of h and h^2 -> partial[blockIdx.x, 0 | 1, the chunk's columns]. The
// batch's real rows are cut into gridDim.x * kStatsWarps equal runs in flat
// order; a warp walks its run, reading each row once in vectors of E
// (whole: the chunk is the row), and each lane adds h and h^2 of its K
// vectors (chunk vectors lane + 32k) into registers. Rows past n_nodes are
// not read. The row norm is cgc::row_rnorm (B4's); h = round_T(relu(p) *
// rnorm) as B4 forms it.
//   !LIN: the rows arrive by cp.async into the warp's kStatsStages stages
//   (bf16 vectors under 4 bytes by plain copies), two rows ahead of the one
//   summed; with more than one chunk the norm reads the whole row from
//   device memory (columns past 1280: no configuration has them).
//   LIN (f32 B9b, E = 1): p formed per column from the row's x3 by
//   cgc::lin_p, in the row norm's order (B9a f32's), into the warp's row
//   copy, and summed from there; formed again per chunk past the first.
// The warps' sums are then added through shared memory in warp order.
// rnorm_out (test only; null on every path): each real row's norm.
template <typename T, int E, bool LIN>
__global__ void __launch_bounds__(kStatsThreads, 2)
    stats_kernel(const T* __restrict__ p, Lin<T> lin,
                 const int* __restrict__ n_nodes, float* __restrict__ partial,
                 float* __restrict__ rnorm_out, int B, int N, int C,
                 int chunk, int wbytes) {
  using namespace cgc::tc;
  constexpr int K = kStatsPerLane / E;  // vectors a lane sums
  constexpr int kVB = E * static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) uint8_t smem_b3[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* wbuf = smem_b3 + static_cast<size_t>(warp) * wbytes;
  const int nvec = C / E;
  const int v0 = blockIdx.y * chunk;     // the chunk's first vector
  const int nv = min(chunk, nvec - v0);  // and its vectors
  const bool whole = gridDim.y == 1;

  long long total = 0;
  for (int b = 0; b < B; ++b) total += real_rows(n_nodes, b, N);
  const long long runs = static_cast<long long>(gridDim.x) * kStatsWarps;
  const long long run =
      static_cast<long long>(blockIdx.x) * kStatsWarps + warp;
  const long long lo = total * run / runs, hi = total * (run + 1) / runs;

  float s[K][E] = {}, q[K][E] = {};
  // value(v, x): the E values of chunk vector v of the row
  auto add_row = [&](float rn, auto&& value) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + 32 * k;
      if (v >= nv) continue;
      float x[E];
      value(v, x);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float h = cgc::round_to<T>(fmaxf(x[e], 0.f) * rn);
        s[k][e] += h;
        q[k][e] = fmaf(h, h, q[k][e]);
      }
    }
  };
  auto keep_rnorm = [&](long long row, float rn) {
    if (rnorm_out != nullptr && lane == 0 && blockIdx.y == 0)
      rnorm_out[row] = rn;
  };

  RealRows at;
  at.start(n_nodes, B, N, lo);
  if constexpr (!LIN) {
    const int slot = wbytes / kStatsStages;
    RealRows ahead = at;
    long long fi = lo;
    auto fetch = [&](int st) {
      if (fi < hi) {
        const T* src =
            p + ahead.row(N) * C + static_cast<long long>(v0) * E;
        uint8_t* dst = wbuf + st * slot;
        for (int v = lane; v < nv; v += 32) {
          if constexpr (kVB >= 4)
            cp_async<kVB>(smem_u32(dst + v * kVB), src + v * E, true);
          else
            *reinterpret_cast<Vec<T, E>*>(dst + v * kVB) =
                *reinterpret_cast<const Vec<T, E>*>(src + v * E);
        }
        ahead.next(n_nodes, B, N);
        ++fi;
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < kStatsStages - 1; ++st) fetch(st);
    for (long long i = lo; i < hi; i += kStatsStages) {
#pragma unroll
      for (int st = 0; st < kStatsStages; ++st) {
        fetch((st + kStatsStages - 1) % kStatsStages);
        cp_async_wait<kStatsStages - 1>();
        __syncwarp();
        if (i + st < hi) {
          const long long row = at.row(N);
          const T* xs = reinterpret_cast<const T*>(wbuf + st * slot);
          auto staged = [&](int v, float(&x)[E]) {
            cgc::load_vec<T, E>(x, xs + v * E);
          };
          const T* pr = p + row * C;
          const float rn =
              whole ? cgc::row_rnorm<E>(nv, lane, staged)
                    : cgc::row_rnorm<E>(nvec, lane, [&](int v, float(&x)[E]) {
                        cgc::load_vec<T, E>(x, pr + v * E);
                      });
          keep_rnorm(row, rn);
          add_row(rn, staged);
          at.next(n_nodes, B, N);
        }
        __syncwarp();  // the stage is read before it is refilled
      }
    }
    cp_async_wait<0>();
  } else {
    float* xs = reinterpret_cast<float*>(wbuf);  // the row's x3 [F3]
    float* prow = xs + (lin.F3 + 3) / 4 * 4;     // p of the chunk
    for (long long i = lo; i < hi; ++i) {
      const long long row = at.row(N);
      for (int k = lane; k < lin.F3; k += 32)
        xs[k] = cgc::to_f32(lin.x3[row * lin.F3 + k]);
      __syncwarp();
      auto p_at = [&](int c) {
        return cgc::lin_p(xs, lin.kc3, lin.b3, lin.F3, C, c);
      };
      float rn;
      if (whole) {  // each lane keeps the columns it sums
        rn = cgc::row_rnorm<1>(C, lane, [&](int c, float(&x)[1]) {
          x[0] = p_at(c);
          prow[c] = x[0];
        });
        add_row(rn, [&](int v, float(&x)[E]) { x[0] = prow[v]; });
      } else {
        rn = cgc::row_rnorm<1>(C, lane, [&](int c, float(&x)[1]) {
          x[0] = p_at(c);
        });
        add_row(rn, [&](int v, float(&x)[E]) { x[0] = p_at(v0 + v); });
      }
      keep_rnorm(row, rn);
      at.next(n_nodes, B, N);
      __syncwarp();  // x3 is read before the next row's lands
    }
  }

  // the block's partial: each warp's sums into a slice of its own, then
  // the slices added in warp order by all the block's threads (one barrier
  // a pass, where warp after warp through one slice made eight); two
  // passes of half the columns, so the slices fit where the rows were
  // staged (f32 B9b reads kc3 through L1, which more shared memory
  // would take)
  const int hv = (nv + 1) / 2;  // vectors a pass
  float* red = reinterpret_cast<float*>(smem_b3);  // [kStatsWarps][2][hv * E]
  float* mine = red + static_cast<size_t>(warp) * 2 * hv * E;
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * C +
               static_cast<long long>(v0) * E;
  for (int h0 = 0; h0 < nv; h0 += hv) {
    const int hc = min(hv, nv - h0) * E;  // this pass's columns
    __syncthreads();  // the stages, or the last pass's slices, are read
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + 32 * k;
      if (v < h0 || v >= h0 + hv || v >= nv) continue;
      Vec<float, E> vs, vq;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        vs.v[e] = s[k][e];
        vq.v[e] = q[k][e];
      }
      *reinterpret_cast<Vec<float, E>*>(mine + (v - h0) * E) = vs;
      *reinterpret_cast<Vec<float, E>*>(mine + hv * E + (v - h0) * E) = vq;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * hc; j += kStatsThreads) {
      const int c = j < hc ? j : hv * E + j - hc;  // within a slice
      float t = red[c];
      for (int w = 1; w < kStatsWarps; ++w) t += red[w * 2 * hv * E + c];
      out[(j < hc ? 0 : C) + h0 * E + (j < hc ? j : j - hc)] = t;
    }
  }
}

// out[j] = the sum over the P partials of partial[i, j], j < C2 (= 2C, the
// column sums then the sums of squares). A block takes 16 consecutive j;
// half-warp g sums partials g, g + 32, ... in order, kRedBatch loads in
// flight, then the 32 half-warps' sums are added in order: the same bits
// run to run.
constexpr int kRedCols = 16;
constexpr int kRedGroups = 32;
constexpr int kRedThreads = kRedCols * kRedGroups;
constexpr int kRedBatch = 8;

__global__ void __launch_bounds__(kRedThreads)
    stats_reduce_kernel(const float* __restrict__ partial, int P, int C2,
                        float* __restrict__ out) {
  __shared__ float s_red[kRedGroups][kRedCols];
  const int t = threadIdx.x, g = t / kRedCols, col = t % kRedCols;
  const int j = blockIdx.x * kRedCols + col;
  float sum = 0.f;
  if (j < C2) {
    for (int i0 = g; i0 < P; i0 += kRedGroups * kRedBatch) {
      float v[kRedBatch];
#pragma unroll
      for (int u = 0; u < kRedBatch; ++u) {
        const int i = i0 + u * kRedGroups;
        v[u] = i < P ? __ldg(partial + static_cast<long long>(i) * C2 + j)
                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRedBatch; ++u) sum += v[u];
    }
  }
  s_red[g][col] = sum;
  __syncthreads();
  if (t >= kRedCols || j >= C2) return;
  float tot = s_red[0][t];
  for (int k = 1; k < kRedGroups; ++k) tot += s_red[k][t];
  out[j] = tot;
}

// ---- B9b in bf16 on the tensor cores ----

constexpr int kLinRows = 64;              // rows per block
constexpr int kLinWarps = kLinRows / 16;  // a warp per 16-row group
constexpr int kLinThreads = 32 * kLinWarps;

// Number of real rows of the kLinRows-row tile starting at flat row0.
__device__ __forceinline__ int tile_rows(long long row0, int N,
                                         const int* __restrict__ n_nodes) {
  const long long b = row0 / N;  // N % kLinRows == 0: one graph per tile
  const long long left = n_nodes[b] - (row0 - b * N);
  return left <= 0 ? 0 : (left < kLinRows ? static_cast<int>(left)
                                          : kLinRows);
}

__global__ void __launch_bounds__(kLinThreads)
    stats_lin_tc_kernel(const bf16* __restrict__ x3,
                        const bf16* __restrict__ kc3t,
                        const bf16* __restrict__ b3,
                        const int* __restrict__ n_nodes,
                        float* __restrict__ partial, int N, int F3, int C) {
  using namespace cgc::tc;
  __shared__ float s_rn[kLinRows];
  __shared__ bf16 s_x3[kLinRows * kF3Pad];  // [kLinRows][F3]
  const long long row0 = static_cast<long long>(blockIdx.x) * kLinRows;
  const int rows = tile_rows(row0, N, n_nodes);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * C;
  if (rows == 0) {  // a tile past n_nodes adds zeros, read by the reduction
    for (int j = t; j < 2 * C; j += kLinThreads) out[j] = 0.f;
    return;
  }
  const int g = lane / 4, tq = lane % 4;
  for (int e = t; e < kLinRows * F3; e += kLinThreads)
    s_x3[e] = x3[row0 * F3 + e];
  __syncthreads();
  {  // phase 1: the row norm of the warp's 16 rows; 0 past the real rows
    uint32_t xf[2][4];
    lin_x3_frags(xf, s_x3, 16 * warp + g, F3, tq);
    float rn0 = 0.f, rn1 = 0.f;
    if (16 * warp < rows) lin_rnorm(rn0, rn1, xf, kc3t, kF3Pad, b3, C, lane);
    if (tq == 0) {
      s_rn[16 * warp + g] = 16 * warp + g < rows ? rn0 : 0.f;
      s_rn[16 * warp + g + 8] = 16 * warp + g + 8 < rows ? rn1 : 0.f;
    }
  }
  __syncthreads();
  // phase 2: the sums, every 8-column tile of the warp over all 64 rows
  uint32_t xf[kLinWarps][2][4];
  float rn[kLinWarps][2];
#pragma unroll
  for (int r = 0; r < kLinWarps; ++r) {
    lin_x3_frags(xf[r], s_x3, 16 * r + g, F3, tq);
    rn[r][0] = s_rn[16 * r + g];
    rn[r][1] = s_rn[16 * r + g + 8];
  }
  for (int jn = warp; jn < (C + 7) / 8; jn += kLinWarps) {
    const int col = 8 * jn + 2 * tq;
    uint32_t bf[4];
    lin_b_frags(bf, kc3t + static_cast<long long>(8 * jn + g) * kF3Pad +
                        2 * tq);
    const float bb0 = col < C ? cgc::to_f32(b3[col]) : 0.f;
    const float bb1 = col + 1 < C ? cgc::to_f32(b3[col + 1]) : 0.f;
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kLinWarps; ++r) {
      float p[4];
      lin_p_frag(p, xf[r], bf, bb0, bb1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g, g + 8; h rounded in pairs
        const float2 h =
            unpack_bf16(pack_bf16(fmaxf(p[2 * hh], 0.f) * rn[r][hh],
                                  fmaxf(p[2 * hh + 1], 0.f) * rn[r][hh]));
        sum[0] += h.x;
        sq[0] = fmaf(h.x, h.x, sq[0]);
        sum[1] += h.y;
        sq[1] = fmaf(h.y, h.y, sq[1]);
      }
    }
    // the eight lanes (g) of a column pair
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o);
        sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], o);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= C) continue;
        out[col + e] = sum[e];
        out[C + col + e] = sq[e];
      }
    }
  }
}

// ---- B5 ----

// elements of p (and of dh) each lane of the register kernel holds: a warp
// holds 1280 columns, the block's eight warps 10240
constexpr int kBwdPerLane = 40;
// shared memory the staged kernel's block may take: its warps' two stages
// of a p row and a dh row each
constexpr int kStagedBytes = 96 * 1024;

// E consecutive f32 values at ``src`` (aligned to 4 * min(E, 4) bytes)
template <int E>
__device__ __forceinline__ void load_f32(float (&d)[E],
                                         const float* __restrict__ src) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
      d[4 * q] = f.x;
      d[4 * q + 1] = f.y;
      d[4 * q + 2] = f.z;
      d[4 * q + 3] = f.w;
    }
  } else if constexpr (E == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(src));
    d[0] = f.x;
    d[1] = f.y;
  } else {
    d[0] = __ldg(src);
  }
}

// E values of dp in T: bf16 pairs by one packed conversion
template <typename T, int E>
__device__ __forceinline__ Vec<T, E> to_vec(const float (&o)[E]) {
  Vec<T, E> r;
  if constexpr (sizeof(T) == 2 && E % 2 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(&r.v[e]) =
          __floats2bfloat162_rn(o[e], o[e + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) r.v[e] = cgc::from_f32<T>(o[e]);
  }
  return r;
}

// A real row in two passes. With r = relu(p), hs = r * rnorm and
// dh_tot = dh + u + 2 hs w, the row sum is
//   sum(dh_tot * hs) = rnorm * sum((dh + u) r) + 2 rnorm^2 * sum(w r^2),
// so pass 1 takes ||p||^2, sum((dh + u) r) and sum(w r^2) together, and pass
// 2 writes dp = [p > 0] rnorm dh_tot - rnorm^2 rd p. Each vector element
// keeps its own partial sums (E chains of additions, not one).
struct RowSums {
  float ss, a, b;  // ||p||^2, sum((dh + u) r), sum(w r^2)
};

template <typename T, int E>
__device__ __forceinline__ void bwd_pass1(float (&ss)[E], float (&a)[E],
                                          float (&b)[E], const Vec<T, E>& x,
                                          const Vec<T, E>& d,
                                          const float (&uu)[E],
                                          const float (&ww)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float v = cgc::to_f32(x.v[e]);
    const float r = fmaxf(v, 0.f);
    ss[e] = fmaf(v, v, ss[e]);
    a[e] = fmaf(cgc::to_f32(d.v[e]) + uu[e], r, a[e]);
    b[e] = fmaf(ww[e] * r, r, b[e]);
  }
}

template <typename T, int E>
__device__ __forceinline__ Vec<T, E> bwd_pass2(const Vec<T, E>& x,
                                               const Vec<T, E>& d,
                                               const float (&uu)[E],
                                               const float (&ww)[E],
                                               float rnorm, float cx) {
  float o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float v = cgc::to_f32(x.v[e]);
    const float hs = fmaxf(v, 0.f) * rnorm;
    const float tot = cgc::to_f32(d.v[e]) + fmaf(2.f * hs, ww[e], uu[e]);
    o[e] = fmaf(-cx, v, v > 0.f ? rnorm * tot : 0.f);
  }
  return to_vec<T, E>(o);
}

template <int E>
__device__ __forceinline__ float sum_of(const float (&a)[E]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += a[e];
  return s;
}

template <int E>
__device__ __forceinline__ RowSums lane_sums(const float (&ss)[E],
                                             const float (&a)[E],
                                             const float (&b)[E]) {
  return {sum_of<E>(ss), sum_of<E>(a), sum_of<E>(b)};
}

__device__ __forceinline__ RowSums warp_sums(RowSums t) {
  return {cgc::warp_sum(t.ss), cgc::warp_sum(t.a), cgc::warp_sum(t.b)};
}

// (rnorm, rnorm^2 * row sum) from a row's totals
__device__ __forceinline__ float2 bwd_scales(RowSums t) {
  const float rnorm = 1.f / fmaxf(sqrtf(t.ss), 1e-12f);
  const float rd = rnorm * t.a + 2.f * rnorm * rnorm * t.b;
  return make_float2(rnorm, rnorm * rnorm * rd);
}

// Whether flat row ``row`` is a real one (< n_nodes of its graph).
__device__ __forceinline__ bool real_row(long long row, long long rows,
                                         int N,
                                         const int* __restrict__ n_nodes) {
  if (row >= rows) return false;
  const long long b = row / N;
  return row - b * N < n_nodes[b];
}

// bf16 rows of an even C up to kStagedBytes / 4 bytes: each warp walks rows
// warp + k * (the grid's warps); the next row's p and dh go to shared
// memory by cp.async (E elements a copy) while this row is computed from
// the other stage, so the reads stay in flight through the arithmetic.
// HOLD: the lane's u and w (its K vectors) stay in registers for every row
// (C up to 32 * kBwdPerLane); else they are read per vector through L1.
template <int E, bool HOLD>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_staged_kernel(const bf16* __restrict__ p,
                           const bf16* __restrict__ dh,
                           const float* __restrict__ u,
                           const float* __restrict__ w,
                           const int* __restrict__ n_nodes,
                           bf16* __restrict__ dp, int N, long long rows,
                           int C, int slot) {
  using namespace cgc::tc;
  using V = Vec<bf16, E>;
  constexpr int K = HOLD ? kBwdPerLane / E : 1;  // the lane's held vectors
  extern __shared__ __align__(16) uint8_t smem_b5[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* buf = smem_b5 + static_cast<size_t>(warp) * 4 * slot;
  const long long step =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const int nvec = C / E;
  float hu[K][E], hw[K][E];
  if constexpr (HOLD) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        load_f32<E>(hu[k], u + v * E);
        load_f32<E>(hw[k], w + v * E);
      }
    }
  }
  // stage st of this warp: the p row at buf + 2 st slot, dh one slot on
  auto fetch = [&](long long r, int st) {
    const bool live = real_row(r, rows, N, n_nodes);
    if (live) {
      const uint32_t sp = smem_u32(buf + 2 * st * slot);
      for (int v = lane; v < nvec; v += 32) {
        cp_async<2 * E>(sp + v * 2 * E, p + r * C + v * E, true);
        cp_async<2 * E>(sp + slot + v * 2 * E, dh + r * C + v * E, true);
      }
    }
    cp_async_commit();
    return live;
  };
  // fn(v, u values, w values) over the lane's vectors
  auto each = [&](auto&& fn) {
    if constexpr (HOLD) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k < nvec) fn(lane + 32 * k, hu[k], hw[k]);
    } else {
      for (int v = lane; v < nvec; v += 32) {
        float uu[E], ww[E];
        load_f32<E>(uu, u + v * E);
        load_f32<E>(ww, w + v * E);
        fn(v, uu, ww);
      }
    }
  };
  long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
                  warp;
  int st = 0;
  bool live = fetch(row, 0);
  for (; row < rows; row += step) {
    const bool next = fetch(row + step, st ^ 1);
    cp_async_wait<1>();
    __syncwarp();
    const V* xp = reinterpret_cast<const V*>(buf + 2 * st * slot);
    const V* xd = reinterpret_cast<const V*>(buf + (2 * st + 1) * slot);
    V* out = reinterpret_cast<V*>(dp + row * C);
    if (!live) {  // dp is exactly 0 past n_nodes: nothing was read
      float z[E] = {};
      for (int v = lane; v < nvec; v += 32) out[v] = to_vec<bf16, E>(z);
    } else {
      float ss[E] = {}, a[E] = {}, b[E] = {};
      each([&](int v, const float(&uu)[E], const float(&ww)[E]) {
        bwd_pass1<bf16, E>(ss, a, b, xp[v], xd[v], uu, ww);
      });
      const float2 sc = bwd_scales(warp_sums(lane_sums<E>(ss, a, b)));
      each([&](int v, const float(&uu)[E], const float(&ww)[E]) {
        out[v] = bwd_pass2<bf16, E>(xp[v], xd[v], uu, ww, sc.x, sc.y);
      });
    }
    __syncwarp();  // the stage is read before it is refilled
    st ^= 1;
    live = next;
  }
  cp_async_wait<0>();
}

// f32 rows, and bf16 rows the staged kernel does not take, any C: W warps
// per row hold up to kWarps * 32 * kBwdPerLane columns of it in registers
// (K vectors of E elements a lane, read once); the vectors past those are
// read in both passes. The row's sums go through warp shuffles, then
// (W > 1) the W warps' sums through shared memory in warp order.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_kernel(const T* __restrict__ p, const T* __restrict__ dh,
                    const float* __restrict__ u, const float* __restrict__ w,
                    const int* __restrict__ n_nodes, T* __restrict__ dp,
                    int N, long long rows, int C, int W) {
  constexpr int K = kBwdPerLane / E;  // vectors per lane held
  using V = Vec<T, E>;
  __shared__ RowSums s_red[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kWarps / W) + warp / W;
  const int first = (warp % W) * 32 + lane;  // the lane's first vector
  const int stride = 32 * W, nvec = C / E;
  const bool live = real_row(row, rows, N, n_nodes);
  const V* pr = reinterpret_cast<const V*>(p + row * C);
  const V* dr = reinterpret_cast<const V*>(dh + row * C);
  V pv[K], dv[K];
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = first + stride * k;
      if (v < nvec) {
        pv[k] = pr[v];
        dv[k] = dr[v];
      }
    }
  }
  float ss[E] = {}, a[E] = {}, b[E] = {};
  float uu[E], ww[E];
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = first + stride * k;
      if (v >= nvec) continue;
      load_f32<E>(uu, u + v * E);
      load_f32<E>(ww, w + v * E);
      bwd_pass1<T, E>(ss, a, b, pv[k], dv[k], uu, ww);
    }
    for (int v = first + stride * K; v < nvec; v += stride) {
      load_f32<E>(uu, u + v * E);
      load_f32<E>(ww, w + v * E);
      bwd_pass1<T, E>(ss, a, b, pr[v], dr[v], uu, ww);
    }
  }
  RowSums t = warp_sums(lane_sums<E>(ss, a, b));
  if (W > 1) {
    if (lane == 0) s_red[warp] = t;
    __syncthreads();
    const RowSums* r = s_red + (warp - warp % W);
    t = r[0];
    for (int j = 1; j < W; ++j) {
      t.ss += r[j].ss;
      t.a += r[j].a;
      t.b += r[j].b;
    }
  }
  if (row >= rows) return;
  const float2 sc = bwd_scales(t);
  V* out = reinterpret_cast<V*>(dp + row * C);
  if (!live) {  // dp is exactly 0 past n_nodes: nothing was read
    const float z[E] = {};
    for (int v = first; v < nvec; v += stride) out[v] = to_vec<T, E>(z);
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = first + stride * k;
    if (v >= nvec) continue;
    load_f32<E>(uu, u + v * E);
    load_f32<E>(ww, w + v * E);
    out[v] = bwd_pass2<T, E>(pv[k], dv[k], uu, ww, sc.x, sc.y);
  }
  for (int v = first + stride * K; v < nvec; v += stride) {
    load_f32<E>(uu, u + v * E);
    load_f32<E>(ww, w + v * E);
    out[v] = bwd_pass2<T, E>(pr[v], dr[v], uu, ww, sc.x, sc.y);
  }
}

// B3 (and f32 B9b) in vectors of E: the column chunk and the grid, both
// functions of the shape alone, then the reduction over the grid's
// partials. ``parts``: the partials the caller's scratch holds.
template <typename T, int E, bool LIN>
cudaError_t launch_stats_as(const T* p, const Lin<T>& lin,
                            const int* n_nodes, float* partial, int parts,
                            float* out, float* rnorm, int B, int N, int C,
                            int device, cudaStream_t st) {
  static_assert(!LIN || E == 1, "B9b forms p one column at a time");
  constexpr int K = kStatsPerLane / E;
  const int nvec = C / E;
  const int chunk = std::min(nvec, 32 * K);
  const int chunks = (nvec + chunk - 1) / chunk;
  const long long rows = static_cast<long long>(B) * N;
  const int blocks = static_cast<int>(std::min<long long>(
      kStatsBlocks,
      std::max<long long>(1, (rows + kStatsMinRows - 1) / kStatsMinRows)));
  if (parts < blocks) return cudaErrorInvalidValue;
  const int cols = chunk * E;
  const int wbytes =
      LIN ? 4 * ((lin.F3 + 3) / 4 * 4 + cols)
          : kStatsStages * ((cols * static_cast<int>(sizeof(T)) + 15) / 16 *
                            16);
  // per warp: its staged rows, then its slices of half the columns
  const int smem = kStatsWarps * std::max(wbytes, 8 * ((chunk + 1) / 2) * E);
  cudaError_t err = allow_smem<stats_kernel<T, E, LIN>>(device);
  if (err != cudaSuccess) return err;
  stats_kernel<T, E, LIN>
      <<<dim3(blocks, chunks), kStatsThreads, smem, st>>>(
          p, lin, n_nodes, partial, rnorm, B, N, C, chunk, wbytes);
  stats_reduce_kernel<<<(2 * C + kRedCols - 1) / kRedCols, kRedThreads, 0,
                        st>>>(partial, blocks, 2 * C, out);
  return cudaGetLastError();
}

// B3: p read in the widest vectors its rows allow (cgc::row_vec, B4's
// choice on the same p)
template <typename T>
cudaError_t launch_stats(const T* p, const int* n_nodes, float* partial,
                         int parts, float* out, float* rnorm, int B, int N,
                         int C, int device, cudaStream_t st) {
  if (C == 0) return cudaGetLastError();
  const Lin<T> none{nullptr, nullptr, nullptr, 0};
  return cgc::with_vec<T>(cgc::row_vec<T>(C, p), [&](auto e) {
    return launch_stats_as<T, decltype(e)::value, false>(
        p, none, n_nodes, partial, parts, out, rnorm, B, N, C, device, st);
  });
}

// bf16 B9b: the tensor-core partials of every kLinRows-row tile (zeros
// past n_nodes), then B3's reduction over them
cudaError_t launch_stats_lin_tc(const bf16* x3, const bf16* kc3t,
                                const bf16* b3, int F3, const int* n_nodes,
                                float* partial, int parts, float* out, int B,
                                int N, int C, cudaStream_t st) {
  const int tiles = static_cast<int>(static_cast<long long>(B) * N / kLinRows);
  if (C == 0) return cudaGetLastError();
  if (parts < tiles) return cudaErrorInvalidValue;
  if (tiles > 0)
    stats_lin_tc_kernel<<<tiles, kLinThreads, 0, st>>>(x3, kc3t, b3, n_nodes,
                                                       partial, N, F3, C);
  stats_reduce_kernel<<<(2 * C + kRedCols - 1) / kRedCols, kRedThreads, 0,
                        st>>>(partial, tiles, 2 * C, out);
  return cudaGetLastError();
}

// The widest vector (elements of T) that the row width and every base
// address allow, at most 16 bytes; u and w (f32) are read min(E, 4)
// values at a time.
template <typename T>
int bwd_vec(int C, const void* p, const void* dh, const void* dp,
            const void* u, const void* w) {
  for (int e = 16 / static_cast<int>(sizeof(T)); e > 1; e /= 2) {
    const uintptr_t vb = e * sizeof(T), fb = 4 * (e < 4 ? e : 4);
    if (C % e == 0 && reinterpret_cast<uintptr_t>(p) % vb == 0 &&
        reinterpret_cast<uintptr_t>(dh) % vb == 0 &&
        reinterpret_cast<uintptr_t>(dp) % vb == 0 &&
        reinterpret_cast<uintptr_t>(u) % fb == 0 &&
        reinterpret_cast<uintptr_t>(w) % fb == 0)
      return e;
  }
  return 1;
}

// W warps per row, the fewest that hold it in registers, at most kWarps
template <typename T, int E>
cudaError_t launch_bwd_regs(const T* p, const T* dh, const float* u,
                            const float* w, const int* n_nodes, T* dp, int N,
                            long long rows, int C, cudaStream_t st) {
  int W = 1;
  while (W < kWarps && W * 32 * kBwdPerLane < C) W *= 2;
  const long long per = kWarps / W;
  tail_bwd_kernel<T, E>
      <<<static_cast<unsigned>((rows + per - 1) / per), kThreads, 0, st>>>(
          p, dh, u, w, n_nodes, dp, N, rows, C, W);
  return cudaGetLastError();
}

// As many blocks as the card holds at once, each of up to kWarps warps
// within kStagedBytes of shared memory, every warp walking its rows. The
// attribute and the blocks an SM holds are asked once per device and row
// width, so a launch makes no query.
template <int E, bool HOLD>
cudaError_t launch_bwd_staged_as(const bf16* p, const bf16* dh,
                                 const float* u, const float* w,
                                 const int* n_nodes, bf16* dp, int N,
                                 long long rows, int C, int slot, int device,
                                 cudaStream_t st) {
  auto kernel = tail_bwd_staged_kernel<E, HOLD>;
  const int nw = std::min(kWarps, kStagedBytes / (4 * slot));
  const int smem = nw * 4 * slot;
  struct Fit {
    int device = -1, slot = -1;
    long long blocks = 0;  // blocks the card holds at once
  };
  static std::mutex mu;
  static Fit fit;
  long long blocks;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (fit.device != device || fit.slot != slot) {
      int sms, per_sm;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            32 * nw, smem);
      if (err != cudaSuccess) return err;
      fit = {device, slot, static_cast<long long>(sms) * per_sm};
    }
    blocks = fit.blocks;
  }
  const long long grid = std::min<long long>((rows + nw - 1) / nw, blocks);
  kernel<<<static_cast<unsigned>(grid), 32 * nw, smem, st>>>(
      p, dh, u, w, n_nodes, dp, N, rows, C, slot);
  return cudaGetLastError();
}

// the staged kernel of vector width E, u and w held when the row fits
template <int E>
cudaError_t launch_bwd_staged(const bf16* p, const bf16* dh, const float* u,
                              const float* w, const int* n_nodes, bf16* dp,
                              int N, long long rows, int C, int slot,
                              int device, cudaStream_t st) {
  if (C <= 32 * kBwdPerLane)
    return launch_bwd_staged_as<E, true>(p, dh, u, w, n_nodes, dp, N, rows,
                                         C, slot, device, st);
  return launch_bwd_staged_as<E, false>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                        slot, device, st);
}

template <typename T>
cudaError_t launch_bwd(const void* p_, const void* dh_, const float* u,
                       const float* w, const int* n_nodes, void* dp_, int B,
                       int N, int C, int device, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * N;
  if (rows == 0 || C == 0) return cudaGetLastError();
  auto p = static_cast<const T*>(p_);
  auto dh = static_cast<const T*>(dh_);
  auto dp = static_cast<T*>(dp_);
  const int vec = bwd_vec<T>(C, p, dh, dp, u, w);
  if constexpr (sizeof(T) == 2) {
    const int slot = (2 * C + 15) / 16 * 16;  // a row's bytes, padded
    if (vec >= 2 && 4 * slot <= kStagedBytes) {
      switch (vec) {
        case 8:
          return launch_bwd_staged<8>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                      slot, device, st);
        case 4:
          return launch_bwd_staged<4>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                      slot, device, st);
        default:
          return launch_bwd_staged<2>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                      slot, device, st);
      }
    }
    return launch_bwd_regs<T, 1>(p, dh, u, w, n_nodes, dp, N, rows, C, st);
  } else {
    switch (vec) {
      case 4:
        return launch_bwd_regs<T, 4>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                     st);
      case 2:
        return launch_bwd_regs<T, 2>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                     st);
      default:
        return launch_bwd_regs<T, 1>(p, dh, u, w, n_nodes, dp, N, rows, C,
                                     st);
    }
  }
}

}  // namespace

// B3: p [B*N, C] in the compute type, n_nodes; partial: f32 scratch
// [parts, 2, C], refused below the grid's blocks (at most kStatsBlocks);
// out: f32 [2, C] (ssum, ssq); rnorm: null, or (test only) f32 [B*N] that
// takes each real row's norm.
extern "C" int cgc_l2relu_stats(const void* p, const void* n_nodes,
                                void* partial, void* out, void* rnorm, int B,
                                int N, int C, int parts, int dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto nn = static_cast<const int*>(n_nodes);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  auto rn = static_cast<float*>(rnorm);
  switch (dtype) {
    case cgc::kF32:
      return launch_stats<float>(static_cast<const float*>(p), nn, part,
                                 parts, o, rn, B, N, C, device, st);
    case cgc::kBF16:
      return launch_stats<bf16>(static_cast<const bf16*>(p), nn, part, parts,
                                o, rn, B, N, C, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// B9b: x3 [B*N, F3], b3 [C] in the compute type; kc3 [F3, C] (f32; null in
// bf16) or kc3t [kt_rows, kt_cols] = [round_up(C, 64), 32], kc3^T padded
// (bf16, ops/assign_head.py pad_lin_kernel; null in f32); partial [parts,
// 2, C]: f32 takes B3's grid (at most kStatsBlocks partials), bf16 one
// partial per 64-row tile (N a multiple of 64); out as for
// cgc_l2relu_stats; rnorm (f32 only): as for cgc_l2relu_stats.
extern "C" int cgc_l2relu_stats_lin(const void* x3, const void* kc3,
                                    const void* kc3t, const void* b3,
                                    const void* n_nodes, void* partial,
                                    void* out, void* rnorm, int B, int N,
                                    int F3, int C, int kt_rows, int kt_cols,
                                    int parts, int dtype, int device,
                                    void* stream) {
  if (F3 <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto nn = static_cast<const int*>(n_nodes);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case cgc::kF32: {
      if (kc3 == nullptr) return cudaErrorInvalidValue;
      if (C == 0) return cudaGetLastError();
      const Lin<float> lin{static_cast<const float*>(x3),
                           static_cast<const float*>(kc3),
                           static_cast<const float*>(b3), F3};
      return launch_stats_as<float, 1, true>(nullptr, lin, nn, part, parts, o,
                                             static_cast<float*>(rnorm), B, N,
                                             C, device, st);
    }
    case cgc::kBF16:
      if (kc3t == nullptr || rnorm != nullptr || N % kLinRows ||
          F3 > cgc::tc::kF3Pad || kt_rows != (C + 63) / 64 * 64 ||
          kt_cols != cgc::tc::kF3Pad)
        return cudaErrorInvalidValue;
      return launch_stats_lin_tc(
          static_cast<const bf16*>(x3), static_cast<const bf16*>(kc3t),
          static_cast<const bf16*>(b3), F3, nn, part, parts, o, B, N, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// B5: p, dh [B*N, C] in the compute type, u, w f32 [C], n_nodes; dp as p
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
      return launch_bwd<float>(p, dh, uf, wf, nn, dp, B, N, C, device,
                               st);
    case cgc::kBF16:
      return launch_bwd<bf16>(p, dh, uf, wf, nn, dp, B, N, C, device,
                              st);
    default:
      return cudaErrorInvalidValue;
  }
}
