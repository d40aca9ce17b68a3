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
// only decide which tiles those are. These kernels read each x tile from
// device memory (L2 serves the re-reads of neighbouring row tiles), so they
// need no table; the wrapper refuses operators that break the window
// contract, which the TPU kernel would compute wrongly.
//
// Bound on the H100: at the slide's wide legs (F = 1140-1152, ~5,400 live
// block slots of 784 x 9 at 100k nuclei) 2*128*128*F per live slot is ~200
// GFLOP, 0.20 ms on the bf16 tensor cores against ~0.07 ms of bytes; each
// slot also streams its [128 x F] x tile from L2 (~1.6 GB at F = 1152).
// Two kernels, chosen by type and width (a dispatch, not a fallback):
//
// bf16 x at F >= 128 — banded_tc_kernel, on the tensor cores. One thread
//   block per (row tile of 128 rows, column chunk of 192: 1152 = 6 x 192,
//   the widest wgmma N whose accumulators, 96 f32 a thread, fit beside the
//   block's fragments; 1140 leaves 12 masked columns in the last chunk).
//   Two warpgroups own 64 rows each and issue wgmma m64n192k16 with the
//   block as the register operand (int8 -> bf16 exactly, in registers) and
//   the slot's x tile as the shared-memory operand. Each slot's x tile and
//   block arrive by cp.async in a ring of stages (3 for int8 blocks, 2 for
//   bf16), so slot m+1 loads while slot m multiplies. Alignment: at F = 1140
//   a bf16 row is 2,280 bytes, 8-byte aligned but not 16, which TMA and
//   16-byte copies cannot address; the kernel takes the widest copy (16, 8
//   or 4 bytes) that F and the base addresses allow — 8-byte cp.async at
//   1140, 16-byte at 1152 — and lays each copy into the 128-byte-swizzled
//   tile itself. An optional i32[B, R] count of slots up to each row tile's
//   last live one (``live_slots``) stops the walk there; without it every
//   slot is walked (B1 writes exact zeros in dead slots, so the result is
//   the same).
//
// f32 x, or F < 128 — banded_kernel, B2's SIMT tile: one thread block per
//   (b, r, column chunk of F), k-steps of 32 staging a transposed [128 x 32]
//   slice of the block and the [32 x FC] slice of x in shared memory, an
//   8 x (FC/16) f32 register tile per thread; the chunks of one row tile run
//   adjacent so the block is read from L2 after its first chunk. It walks
//   all M slots. (f32 on the tensor cores would mean TF32, which the f32
//   path's tolerances do not allow.)

#include "common.cuh"
#include "tc.cuh"

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


// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;  // two warpgroups of 64 rows each
// x tile of one slot: [128 K rows x 192 columns] as three swizzle atoms
constexpr uint32_t kXAtom = cgc::kTile * 128;
constexpr uint32_t kXStage = 3 * kXAtom;
// the slot's block, row-major, rows padded by 16 bytes so the fragment
// reads of 8 rows hit 8 different bank groups
template <typename V>
__host__ __device__ constexpr int a_stride() {
  return cgc::kTile * static_cast<int>(sizeof(V)) + 16;
}
// a multiple of 1024, so the atoms of every stage stay aligned
template <typename V>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return kXStage + cgc::kTile * a_stride<V>();
}
// 3 stages of 66 KB (int8 blocks), 2 of 82 KB (bf16)
template <typename V>
__host__ __device__ constexpr int tc_stages() {
  return sizeof(V) == 1 ? 3 : 2;
}

// A[row][k], A[row][k+1] of the block as one bf16 pair (int8: exact)
__device__ __forceinline__ uint32_t a_pair(const int8_t* row, int k) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(row + k);
  return cgc::tc::pack_bf16(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                            static_cast<float>(static_cast<int8_t>(v >> 8)));
}
__device__ __forceinline__ uint32_t a_pair(const bf16* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}

template <typename V, int VEC>
__global__ void __launch_bounds__(kTcThreads, 1) banded_tc_kernel(
    const V* __restrict__ vals, const int* __restrict__ blk_cols,
    const int* __restrict__ slots, const bf16* __restrict__ x,
    const bf16* __restrict__ halo, const bf16* __restrict__ acc,
    const bf16* __restrict__ sw, bf16* __restrict__ out,
    bf16* __restrict__ out_tail, int R, int M, int ns_tiles, int NX, int NH,
    int F, int NA) {
  using namespace cgc::tc;
  constexpr int S = tc_stages<V>();
  constexpr uint32_t SB = stage_bytes<V>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;

  const long long br = blockIdx.y;  // b * R + r
  const long long b = br / R;
  const int r = static_cast<int>(br % R);
  const int f0 = blockIdx.x * kN;
  const int t = threadIdx.x;
  const int nslots = slots != nullptr ? min(slots[br], M) : M;
  const bf16* xb = x + b * NX * static_cast<long long>(F);
  const bf16* hb = halo ? halo + b * NH * static_cast<long long>(F) : nullptr;

  // slot m's x tile (swizzled) and block into stage m % S
  auto load = [&](int m) {
    const long long blk = br * M + m;
    const int c = blk_cols[blk];
    const bf16* src = xb;
    long long row0 = static_cast<long long>(c) * cgc::kTile;
    int nrows = NX;
    if (c >= ns_tiles && hb != nullptr) {
      src = hb;
      row0 = static_cast<long long>(c - ns_tiles) * cgc::kTile;
      nrows = NH;
    }
    const uint32_t st = sbase + (m % S) * SB;
    constexpr int EL = VEC / 2, PER_ROW = kN / EL;
#pragma unroll 4
    for (int e = t; e < cgc::kTile * PER_ROW; e += kTcThreads) {
      const int k = e / PER_ROW, col = (e % PER_ROW) * EL;
      const long long xr = row0 + k;
      const int f = f0 + col;
      const bool ok = xr >= 0 && xr < nrows && f < F;
      cp_async<VEC>(st + swz_offset(k, col, kXAtom),
                    ok ? src + xr * F + f : src, ok);
    }
    const uint8_t* a = reinterpret_cast<const uint8_t*>(
        vals + blk * cgc::kTile * cgc::kTile);
    constexpr int RB = cgc::kTile * static_cast<int>(sizeof(V)), CPR = RB / 16;
#pragma unroll
    for (int e = t; e < cgc::kTile * CPR; e += kTcThreads) {
      const int row = e / CPR, q = e % CPR;
      cp_async<16>(st + kXStage + row * a_stride<V>() + q * 16,
                   a + row * RB + q * 16, true);
    }
  };

  float d[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) d[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nslots) load(s);
    cp_async_commit();
  }
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  const int ra = (t / 128) * 64 + ((t / 32) % 4) * 16 + g;  // rows ra, ra+8
  for (int m = 0; m < nslots; ++m) {
    cp_async_wait<S - 2>();
    __syncthreads();  // slot m landed; every thread is done with slot m-1
    if (m + S - 1 < nslots) load(m + S - 1);
    cp_async_commit();
    const uint32_t st = (m % S) * SB;
    const V* a0 = reinterpret_cast<const V*>(smem + st + kXStage +
                                             ra * a_stride<V>());
    const V* a1 = reinterpret_cast<const V*>(smem + st + kXStage +
                                             (ra + 8) * a_stride<V>());
    // each k-step's product is issued as soon as its A fragment is formed,
    // so converting the next fragment overlaps it
    uint32_t af[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int k = ks * 16 + 2 * tq;
      af[ks][0] = a_pair(a0, k);
      af[ks][1] = a_pair(a1, k);
      af[ks][2] = a_pair(a0, k + 8);
      af[ks][3] = a_pair(a1, k + 8);
      wgmma_fence();
      wgmma_m64n192k16_rs(
          d, af[ks], desc_mn_sw128(sbase + st + ks * 16 * 128, kXAtom, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
  }

  // acc / split outputs and the epilogue take B == 1 (the wrapper checks)
  const long long rows_b = static_cast<long long>(R) * cgc::kTile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = static_cast<long long>(r) * cgc::kTile + ra + 8 * h;
    float sc = 0.f, sf = 0.f;
    if (sw != nullptr) {
      sc = cgc::to_f32(sw[row * 128]);
      sf = cgc::to_f32(sw[row * 128 + 1]);
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int f = f0 + 8 * j + 2 * tq;
      if (f >= F) continue;  // F is even: f + 1 < F too
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (acc != nullptr) {
        if (row < NA) {
          const float2 av = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(acc + row * F + f));
          *reinterpret_cast<__nv_bfloat162*>(out + row * F + f) =
              __floats2bfloat162_rn(v0 + av.x, v1 + av.y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out_tail + (row - NA) * F + f) =
              __floats2bfloat162_rn(v0, v1);
        }
        continue;
      }
      if (sw != nullptr) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + row * F + f));
        v0 = sc * v0 + sf * xv.x;
        v1 = sc * v1 + sf * xv.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (b * rows_b + row) * F + f) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <typename V, int VEC>
cudaError_t launch_tc_vec(const void* vals, const int* blk_cols,
                          const int* slots, const void* x, const void* halo,
                          const void* acc, const void* sw, void* out,
                          void* out_tail, int B, int R, int M, int ns_tiles,
                          int NX, int NH, int F, int NA, cudaStream_t s) {
  const size_t smem = tc_stages<V>() * stage_bytes<V>() + 1024;
  auto kern = banded_tc_kernel<V, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((F + cgc::tc::kN - 1) / cgc::tc::kN,
                  static_cast<unsigned>(B) * R);
  if (grid.x > 0 && grid.y > 0) {
    kern<<<grid, kTcThreads, smem, s>>>(
        static_cast<const V*>(vals), blk_cols, slots,
        static_cast<const bf16*>(x), static_cast<const bf16*>(halo),
        static_cast<const bf16*>(acc), static_cast<const bf16*>(sw),
        static_cast<bf16*>(out), static_cast<bf16*>(out_tail), R, M, ns_tiles,
        NX, NH, F, NA);
  }
  return cudaGetLastError();
}

// the widest copy that F and the base addresses allow; bf16 pairs are read
// and written 4 bytes at a time (acc, x in the epilogue, the outputs)
template <typename V>
cudaError_t launch_tc(const void* vals, const int* blk_cols, const int* slots,
                      const void* x, const void* halo, const void* acc,
                      const void* sw, void* out, void* out_tail, int B, int R,
                      int M, int ns_tiles, int NX, int NH, int F, int NA,
                      cudaStream_t s) {
  const auto misaligned = [](const void* p, uintptr_t n) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % n != 0;
  };
  if (misaligned(vals, 16) || misaligned(acc, 4) || misaligned(out, 4) ||
      misaligned(out_tail, 4))
    return cudaErrorMisalignedAddress;
  switch (cgc::tc::copy_width(F, x, halo)) {
    case 16:
      return launch_tc_vec<V, 16>(vals, blk_cols, slots, x, halo, acc, sw,
                                  out, out_tail, B, R, M, ns_tiles, NX, NH, F,
                                  NA, s);
    case 8:
      return launch_tc_vec<V, 8>(vals, blk_cols, slots, x, halo, acc, sw, out,
                                 out_tail, B, R, M, ns_tiles, NX, NH, F, NA,
                                 s);
    case 4:
      return launch_tc_vec<V, 4>(vals, blk_cols, slots, x, halo, acc, sw, out,
                                 out_tail, B, R, M, ns_tiles, NX, NH, F, NA,
                                 s);
    default:
      return cudaErrorMisalignedAddress;
  }
}

}  // namespace

// halo, acc, epilogue_sw, out_tail and live_slots may be null; out_tail is
// needed exactly when acc covers NA < R*128 rows. vals_dtype: x's code or
// kI8. bf16 at F >= 128 takes the tensor-core kernel (F even; it reads
// live_slots), everything else the SIMT kernel (which walks all M slots).
extern "C" int cgc_bsr_matmul_banded(
    const void* vals, const void* blk_cols, const void* x, const void* halo,
    const void* acc, const void* epilogue_sw, void* out, void* out_tail,
    const void* live_slots, int B, int R, int M, int ns_tiles, int NX, int NH,
    int F, int NA, int vals_dtype, int dtype, int device, void* stream) {
  if ((acc != nullptr || epilogue_sw != nullptr) && B != 1)
    return cudaErrorInvalidValue;
  if (acc != nullptr && NA < R * cgc::kTile && out_tail == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto bc = static_cast<const int*>(blk_cols);
  auto slots = static_cast<const int*>(live_slots);
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
      if (F >= 128)
        return i8 ? launch_tc<int8_t>(vals, bc, slots, x, halo, acc,
                                      epilogue_sw, out, out_tail, B, R, M,
                                      ns_tiles, NX, NH, F, NA, s)
                  : launch_tc<bf16>(vals, bc, slots, x, halo, acc,
                                    epilogue_sw, out, out_tail, B, R, M,
                                    ns_tiles, NX, NH, F, NA, s);
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
