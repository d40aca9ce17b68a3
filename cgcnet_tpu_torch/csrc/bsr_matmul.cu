// B2 — block-sparse matmul over the precomputed blocks of B1.
//
// Replaces cgcnet_tpu/ops/pallas/bsr_kernel.py: bsr_matmul (the resident
// variant _bsr_mm_resident_kernel and the streamed variant
// _make_streamed_kernel — on this card one kernel per type serves every
// width):
//
//   out[b, r*128 : (r+1)*128] = sum_m vals[b, r, m] @ x[b, c*128 : c*128+128]
//   with c = blk_cols[b, r, m], m < live_slots[b, r],
//
// accumulated in f32 and stored in x's type. The operator may be
// rectangular: x has NC rows, out has R*128; rows of x at or past NC read as
// zero, so the kernel never reads outside x. ``live_slots`` (ops/bsr.py
// live_slot_counts) is each row tile's count of block slots up to its last
// live one; B1 writes exact-zero blocks in the slots past it, so stopping
// there changes no value. A row tile without a live slot writes zeros.
//
// Bound on the H100: the live blocks' bytes at the narrow widths (F = 18,
// 40: a 128 x 128 block is 16 KB in int8, 64 KB in f32, and feeds only 2*F
// operations per element), the operations (2*128*128*F per live block) at
// F = 1140. Each thread block takes one (b, r) row tile and one chunk of FC
// columns (F rounded up to a multiple of 8 on the narrow legs: 24 at F = 18,
// 40 at F = 40; chunks of 128 above 64) and walks the row tile's live slots
// only. Column chunks of one (b, r) are adjacent in the launch order, so
// the blocks that re-read the same 128 x 128 block find it in L2.
//
// bf16 x (int8 or bf16 blocks): bsr_matmul_tc_kernel, on the tensor cores
// by mma.sync m16n8k16 (bf16 in, f32 sums). Each of 8 warps owns 16 rows of
// the tile. The 128-deep product of a slot runs over k in a permuted order
// (k-step s, lane quarter tq: k = 32 tq + 4 s + e, e = 0..3 for the
// fragment's k = 2tq, 2tq+1, 2tq+8, 2tq+9): the same products, summed in
// another order, so each lane reads its 32 block values of a row as 16-byte
// loads straight into registers, converted there to bf16 A fragments (an
// int8 value is exact in bf16). x's [128 x FC] slice goes into shared
// memory by cp.async at the widest copy the row width and base addresses
// allow (4 bytes at F = 18, 16 at F = 40, 8 at F = 1140), rows padded so
// the ldmatrix.trans reads of the B fragments at the permuted k hit eight
// bank groups; the next slot's x slice and block registers load while the
// current slot multiplies. wgmma would take 64-row warpgroup tiles and
// descriptors that buy nothing at n = 24 and 40, where the block bytes
// bound the leg.
//
// f32 x (f32 or int8 blocks): bsr_matmul_f32_kernel, exact f32 on the CUDA
// cores (no TF32: the f32 tolerances assume strict f32). k-steps of 32 over
// the live slots; each step's [128 x 32] block slice (16-byte copies: 4 f32
// or 16 int8) and [32 x FC] x slice go into shared memory by cp.async, the
// next step's while the current one multiplies; each thread keeps a TM x
// TN register tile of f32 sums and reads the block slice as 16-byte vectors
// along k (a quarter warp shares its rows: broadcast reads).

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kT = cgc::kTile;
constexpr int kThreads = 256;

// Copy ``vec`` bytes (16, 8 or 4 by cp.async; 2 synchronously) of global
// ``src`` to shared ``dst``, or zeros when !valid.
__device__ __forceinline__ void copy_vec(uint32_t dst, const void* src,
                                         bool valid, int vec) {
  using cgc::tc::cp_async;
  switch (vec) {
    case 16:
      cp_async<16>(dst, src, valid);
      break;
    case 8:
      cp_async<8>(dst, src, valid);
      break;
    case 4:
      cp_async<4>(dst, src, valid);
      break;
    default: {
      const uint16_t v = valid ? *static_cast<const uint16_t*>(src) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v)
                   : "memory");
    }
  }
}

__device__ __forceinline__ int live_count(const int* __restrict__ live,
                                          long long br, int M) {
  return min(max(live[br], 0), M);
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Row stride (bf16) of the x slice: FC, or FC + 8 when FC / 8 is even, so
// a row's 16-byte chunk index steps by an odd number; and 16 more bf16 every
// 32 rows, so the permuted k rows of one ldmatrix (32 tq + e for tq = 0..3,
// e = 0..1) fall in eight different chunks.
template <int NT>
__host__ __device__ constexpr int x_stride() {
  return 8 * NT + (NT % 2 == 0 ? 8 : 0);
}
template <int NT>
__host__ __device__ constexpr int x_row_off(int k) {
  return k * x_stride<NT>() + 16 * (k / 32);
}
template <int NT>
__host__ __device__ constexpr uint32_t x_stage_bytes() {
  return 2u * x_row_off<NT>(kT);
}

// 16-byte vectors of a slot's block per lane and row: 32 values of k.
template <typename V>
__host__ __device__ constexpr int a_vecs() {
  return static_cast<int>(sizeof(V)) * 32 / 16;  // int8 2, bf16 4
}

// The lane's 32 block values of rows r0 and r0 + 8 (k = 32 tq .. + 31).
template <typename V>
__device__ __forceinline__ void load_a(uint4 (&a)[2][a_vecs<V>()],
                                       const V* __restrict__ blk, int r0,
                                       int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4* src =
        reinterpret_cast<const uint4*>(blk + (r0 + 8 * h) * kT + 32 * tq);
#pragma unroll
    for (int v = 0; v < a_vecs<V>(); ++v) a[h][v] = __ldg(src + v);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// two int8 values (bytes ``lo`` and lo + 1 of w) as a bf16 pair
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int lo) {
  return cgc::tc::pack_bf16(
      static_cast<float>(static_cast<int8_t>(w >> (8 * lo))),
      static_cast<float>(static_cast<int8_t>(w >> (8 * lo + 8))));
}

// A fragment of k-step s from the lane's block registers.
template <typename V>
__device__ __forceinline__ void a_frag(uint32_t (&af)[4],
                                       const uint4 (&a)[2][a_vecs<V>()],
                                       int s) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (sizeof(V) == 1) {  // int8: bytes 4s .. 4s + 3
      const uint32_t w = word_of(a[h][s / 4], s % 4);
      af[h] = i8x2_bf16(w, 0);
      af[2 + h] = i8x2_bf16(w, 2);
    } else {  // bf16: values 4s .. 4s + 3, two words
      af[h] = word_of(a[h][s / 2], 2 * (s % 2));
      af[2 + h] = word_of(a[h][s / 2], 2 * (s % 2) + 1);
    }
  }
}

template <typename V, int NT>
__global__ void __launch_bounds__(kThreads) bsr_matmul_tc_kernel(
    const V* __restrict__ vals, const int* __restrict__ blk_cols,
    const int* __restrict__ live_slots, const bf16* __restrict__ x,
    bf16* __restrict__ out, int R, int M, int NC, int F, int vec) {
  constexpr int FC = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem_x[];
  const uint32_t sbase = cgc::tc::smem_u32(smem_x);
  const long long br = blockIdx.y;  // b * R + r
  const long long b = br / R;
  const int f0 = blockIdx.x * FC;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;  // the lane's rows r0, r0 + 8
  const bf16* xb = x + b * NC * static_cast<long long>(F);
  const int live = live_count(live_slots, br, M);

  // x rows x_row0 .. + 127, columns f0 .. f0 + FC - 1, into stage ``st``
  auto load_x = [&](int st, int x_row0) {
    const int per_row = FC * 2 / vec;
    for (int e = t; e < kT * per_row; e += kThreads) {
      const int k = e / per_row, c = (e % per_row) * (vec / 2);
      const int xr = x_row0 + k, f = f0 + c;
      const bool ok = xr < NC && f < F;
      copy_vec(sbase + st * x_stage_bytes<NT>() + 2 * (x_row_off<NT>(k) + c),
               ok ? xb + static_cast<long long>(xr) * F + f : xb, ok, vec);
    }
  };

  // the lane's ldmatrix row: matrix mi = lane / 8 (k rows e = 0,1 or 2,3;
  // n-tile j or j + 1), row i = lane % 8 (tq = i / 2, e = i % 2)
  const int mi = lane / 8, li = lane % 8;
  const int k_lane = 32 * (li / 2) + (li % 2) + 2 * (mi % 2);
  const int n_lane = 8 * (mi / 2);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if (live > 0) {
    const V* vb = vals + br * M * kT * kT;
    const int* cb = blk_cols + br * M;
    uint4 a_cur[2][a_vecs<V>()], a_nxt[2][a_vecs<V>()];
    load_x(0, cb[0] * kT);
    cgc::tc::cp_async_commit();
    load_a<V>(a_cur, vb, r0, tq);
    for (int m = 0; m < live; ++m) {
      if (m + 1 < live) {
        load_x((m + 1) % 2, cb[m + 1] * kT);
        load_a<V>(a_nxt, vb + static_cast<long long>(m + 1) * kT * kT, r0,
                  tq);
      }
      cgc::tc::cp_async_commit();
      cgc::tc::cp_async_wait<1>();
      __syncthreads();  // slot m's x slice landed for every thread
      const uint32_t xs = sbase + (m % 2) * x_stage_bytes<NT>();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        uint32_t af[4];
        a_frag<V>(af, a_cur, s);
        const uint32_t row = xs + 2 * x_row_off<NT>(k_lane + 4 * s);
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t b0, b1, b2, b3;
          cgc::tc::ldmatrix_x4_trans(b0, b1, b2, b3,
                                     row + 2 * (8 * j + n_lane));
          cgc::tc::mma_m16n8k16(acc[j], af, b0, b1);
          cgc::tc::mma_m16n8k16(acc[j + 1], af, b2, b3);
        }
        if constexpr (NT % 2) {
          uint32_t b0, b1;
          cgc::tc::ldmatrix_x2_trans(b0, b1, row + 2 * 8 * (NT - 1));
          cgc::tc::mma_m16n8k16(acc[NT - 1], af, b0, b1);
        }
      }
      __syncthreads();  // every thread is done with stage m % 2
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < a_vecs<V>(); ++v) a_cur[h][v] = a_nxt[h][v];
    }
  }

  bf16* ob = out + br * kT * static_cast<long long>(F);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int f = f0 + 8 * j + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* o = ob + static_cast<long long>(r0 + 8 * h) * F + f;
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (F % 2 == 0 && f + 1 < F) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (f < F) o[0] = __float2bfloat16(v0);
        if (f + 1 < F) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 x: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK = 32;  // k per step

// CG column groups x TN columns (FC = CG * TN), 256 / CG row groups x TM
// rows. Column j of a thread: tx * TN + j, or (TN a multiple of 4) runs of
// four tx * 4 + j % 4 at (j / 4) * CG * 4, so a quarter warp reads 128
// contiguous bytes.
template <int CG, int TN>
__device__ __forceinline__ int f32_col(int tx, int j) {
  if constexpr (TN % 4 == 0) return (j / 4) * CG * 4 + tx * 4 + j % 4;
  return tx * TN + j;
}

template <typename V, int CG, int TN>
__host__ __device__ constexpr uint32_t f32_stage_bytes() {
  return kT * kBK * sizeof(V) + kBK * CG * TN * sizeof(float);
}

template <typename V, int CG, int TN>
__global__ void __launch_bounds__(kThreads) bsr_matmul_f32_kernel(
    const V* __restrict__ vals, const int* __restrict__ blk_cols,
    const int* __restrict__ live_slots, const float* __restrict__ x,
    float* __restrict__ out, int R, int M, int NC, int F, int vec) {
  constexpr int FC = CG * TN, RG = kThreads / CG, TM = kT / RG;
  constexpr int KV = 16 / sizeof(V);  // block values in a 16-byte vector
  constexpr uint32_t kABytes = kT * kBK * sizeof(V);
  extern __shared__ __align__(16) uint8_t smem_f[];
  const uint32_t sbase = cgc::tc::smem_u32(smem_f);
  const long long br = blockIdx.y;
  const long long b = br / R;
  const int f0 = blockIdx.x * FC;
  const int t = threadIdx.x, tx = t % CG, ty = t / CG;
  const float* xb = x + b * NC * static_cast<long long>(F);
  const int live = live_count(live_slots, br, M);
  const V* vb = vals + br * M * kT * kT;
  const int* cb = blk_cols + br * M;

  // k-step q (slot q / 4, k0 = (q % 4) * 32) into stage ``st``: the block
  // slice [128 rows x 32 k] as stored (k contiguous), x rows k0 .. + 31 of
  // the slot's column tile
  auto load = [&](int st, int q) {
    const int m = q / (kT / kBK), k0 = (q % (kT / kBK)) * kBK;
    const uint32_t sa = sbase + st * f32_stage_bytes<V, CG, TN>();
    const V* blk = vb + static_cast<long long>(m) * kT * kT;
    constexpr int a_per_row = kBK / KV;
    for (int e = t; e < kT * a_per_row; e += kThreads) {
      const int row = e / a_per_row, c = (e % a_per_row) * KV;
      cgc::tc::cp_async<16>(sa + (row * kBK + c) * sizeof(V),
                            blk + row * kT + k0 + c, true);
    }
    const int x_row0 = cb[m] * kT + k0;
    const int per_row = FC * 4 / vec;
    for (int e = t; e < kBK * per_row; e += kThreads) {
      const int k = e / per_row, c = (e % per_row) * (vec / 4);
      const int xr = x_row0 + k, f = f0 + c;
      const bool ok = xr < NC && f < F;
      copy_vec(sa + kABytes + (k * FC + c) * 4,
               ok ? xb + static_cast<long long>(xr) * F + f : xb, ok, vec);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int steps = live * (kT / kBK);
  if (steps > 0) {
    load(0, 0);
    cgc::tc::cp_async_commit();
  }
  for (int q = 0; q < steps; ++q) {
    if (q + 1 < steps) load((q + 1) % 2, q + 1);
    cgc::tc::cp_async_commit();
    cgc::tc::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = smem_f + (q % 2) * f32_stage_bytes<V, CG, TN>();
    const V* As = reinterpret_cast<const V*>(st);
    const float* Bs = reinterpret_cast<const float*>(st + kABytes);
#pragma unroll
    for (int kv = 0; kv < kBK; kv += KV) {
      uint4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const uint4*>(As + (ty * TM + i) * kBK + kv);
#pragma unroll
      for (int e = 0; e < KV; ++e) {
        float bv[TN];
        const float* brow = Bs + (kv + e) * FC;
        if constexpr (TN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(brow + f32_col<CG, TN>(tx, j));
            bv[j] = v4.x;
            bv[j + 1] = v4.y;
            bv[j + 2] = v4.z;
            bv[j + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = brow[f32_col<CG, TN>(tx, j)];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float av;
          if constexpr (sizeof(V) == 1) {
            av = static_cast<float>(
                static_cast<int8_t>(word_of(a[i], e / 4) >> (8 * (e % 4))));
          } else {
            av = __uint_as_float(word_of(a[i], e));
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with stage q % 2
  }

  float* ob = out + br * kT * static_cast<long long>(F);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + f32_col<CG, TN>(tx, j);
      if (f < F) ob[static_cast<long long>(row) * F + f] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct MMArgs {
  const void* vals;
  const int* blk_cols;
  const int* live;
  const void* x;
  void* out;
  int B, R, M, NC, F;
};

template <typename V, int NT>
cudaError_t launch_tc(const MMArgs& a, int vec, cudaStream_t s) {
  auto kern = bsr_matmul_tc_kernel<V, NT>;
  const size_t smem = 2 * x_stage_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.F + 8 * NT - 1) / (8 * NT),
                  static_cast<unsigned>(a.B) * a.R);
  if (grid.x > 0 && grid.y > 0)
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const V*>(a.vals), a.blk_cols, a.live,
        static_cast<const bf16*>(a.x), static_cast<bf16*>(a.out), a.R, a.M,
        a.NC, a.F, vec);
  return cudaGetLastError();
}

// bf16 x: FC = F rounded up to 8 (16, 24, 32, 40, 64), chunks of 128 above
// 64; x's rows copied 16, 8 or 4 bytes at a time as F and the base address
// allow (2, synchronously, for an odd F)
template <typename V>
cudaError_t launch_bf16(const MMArgs& a, cudaStream_t s) {
  int vec = cgc::tc::copy_width(a.F, a.x);
  if (vec == 0) vec = 2;
  if (a.F <= 16) return launch_tc<V, 2>(a, vec, s);
  if (a.F <= 24) return launch_tc<V, 3>(a, vec, s);
  if (a.F <= 32) return launch_tc<V, 4>(a, vec, s);
  if (a.F <= 40) return launch_tc<V, 5>(a, vec, s);
  if (a.F <= 64) return launch_tc<V, 8>(a, vec, s);
  return launch_tc<V, 16>(a, vec, s);
}

template <typename V, int CG, int TN>
cudaError_t launch_f32_tile(const MMArgs& a, int vec, cudaStream_t s) {
  auto kern = bsr_matmul_f32_kernel<V, CG, TN>;
  const size_t smem = 2 * f32_stage_bytes<V, CG, TN>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.F + CG * TN - 1) / (CG * TN),
                  static_cast<unsigned>(a.B) * a.R);
  if (grid.x > 0 && grid.y > 0)
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const V*>(a.vals), a.blk_cols, a.live,
        static_cast<const float*>(a.x), static_cast<float*>(a.out), a.R, a.M,
        a.NC, a.F, vec);
  return cudaGetLastError();
}

// f32 x: FC = 24, 40, 64 or chunks of 128 (8 x 3, 8 x 5, 16 x 4, 16 x 8
// column groups x columns); x's rows copied 16, 8 or 4 bytes at a time
template <typename V>
cudaError_t launch_f32(const MMArgs& a, cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.x);
  const int vec = (a.F % 4 == 0 && base % 16 == 0)  ? 16
                  : (a.F % 2 == 0 && base % 8 == 0) ? 8
                                                    : 4;
  if (a.F <= 24) return launch_f32_tile<V, 8, 3>(a, vec, s);
  if (a.F <= 40) return launch_f32_tile<V, 8, 5>(a, vec, s);
  if (a.F <= 64) return launch_f32_tile<V, 16, 4>(a, vec, s);
  return launch_f32_tile<V, 16, 8>(a, vec, s);
}

}  // namespace

// vals_dtype: x's code, or kI8; live_slots: i32[B, R], required
extern "C" int cgc_bsr_matmul(const void* vals, const void* blk_cols,
                              const void* live_slots, const void* x,
                              void* out, int B, int R, int M, int NC, int F,
                              int vals_dtype, int dtype, int device,
                              void* stream) {
  if (live_slots == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const MMArgs a{vals, static_cast<const int*>(blk_cols),
                 static_cast<const int*>(live_slots), x, out, B, R, M, NC, F};
  const bool i8 = vals_dtype == cgc::kI8;
  if (!i8 && vals_dtype != dtype) return cudaErrorInvalidValue;
  switch (dtype) {
    case cgc::kF32:
      return i8 ? launch_f32<int8_t>(a, s) : launch_f32<float>(a, s);
    case cgc::kBF16:
      return i8 ? launch_bf16<int8_t>(a, s) : launch_bf16<bf16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
