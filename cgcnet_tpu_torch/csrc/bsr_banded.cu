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
// f32 x, or F < 128 — banded_kernel, a gather over the blocks' nonzeros
//   (gather.cuh). The slide's blocks are binary, ~9 nonzeros a row over
//   ~7 live slots of 128 columns: ~1% of each block, so the dense product
//   is ~99% fmaf(0, x, s). One warp a row of the output, rows in order
//   (consecutive row tiles in neighbouring blocks: L2 serves the x rows
//   that neighbours share). It walks the row tile's slots below
//   ``live_slots`` where given (else all M: dead slots are exact zeros);
//   for each slot the warp reads the row's 128 block values once for all
//   of F (4 a lane, one vector load; the next slot's are loaded while this
//   one's are used), takes its nonzero columns in ascending order (a ballot,
//   then each lane's 4 in order) and makes each a term: the value (x's type
//   or int8, in f32) times the source row of x or the halo, as above.
//   The terms are added in that order into f32 sums, lanes across F in the
//   widest vectors that F and the bases allow, then the acc / split
//   outputs, the epilogue or neither. Each output is the dense product's
//   fmaf chain over slots and columns in order without its zero terms, so
//   it is bit-equal to it for finite x, and each block row is read once.
//   Bound: the bytes of the blocks, x, the output (and acc) and the x rows
//   of the nonzeros from L2; 2 * nnz * F operations. Blocks with many
//   nonzeros (dense random f32 blocks) give the same bits, more slowly.
//   (f32 on the tensor cores would mean TF32, which the f32 path's
//   tolerances do not allow.)

#include "common.cuh"
#include "gather.cuh"
#include "tc.cuh"

namespace {

using cgc::gather::kFull;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename V, typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads) banded_kernel(
    const V* __restrict__ vals, const int* __restrict__ blk_cols,
    const int* __restrict__ slots, const T* __restrict__ x,
    const T* __restrict__ halo, const T* __restrict__ acc,
    const T* __restrict__ sw, T* __restrict__ out, T* __restrict__ out_tail,
    int B, int R, int M, int ns_tiles, int NX, int NH, int F, int NA) {
  const int lane = threadIdx.x % 32;
  const long long rows_b = static_cast<long long>(R) * cgc::kTile;
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (g >= B * rows_b) return;  // the whole warp
  const long long b = g / rows_b;
  const long long row = g % rows_b;  // the output row within graph b
  const long long br = b * R + row / cgc::kTile;
  const int nslots = slots != nullptr ? min(slots[br], M) : M;
  const T* xb = x + b * NX * static_cast<long long>(F);
  const T* hb = halo ? halo + b * NH * static_cast<long long>(F) : nullptr;
  // this row of slot m's block: its 4 values at columns 4 * lane .. (f32)
  const auto block_row = [&](float (&a)[4], int m) {
    cgc::load_vec<V, 4>(a, vals + ((br * M + m) * cgc::kTile +
                                   row % cgc::kTile) * cgc::kTile + 4 * lane);
  };
  // the row tile's first 32 column tiles one a lane, read at once
  const int col0 = lane < nslots ? blk_cols[br * M + lane] : 0;
  const int nvec = F / VEC;
  for (int v0 = 0; v0 < nvec; v0 += 32 * NV) {
    cgc::gather::Row<T, VEC, NV> sum(v0, nvec);
    float next[4] = {0.f, 0.f, 0.f, 0.f};
    if (nslots > 0) block_row(next, 0);
    for (int m = 0; m < nslots; ++m) {
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = next[e];
      if (m + 1 < nslots) block_row(next, m + 1);
      const int c =
          m < 32 ? __shfl_sync(kFull, col0, m) : blk_cols[br * M + m];
      // the column tile's source rows: x's own tiles, then the halo
      const T* src = xb;
      long long row0 = static_cast<long long>(c) * cgc::kTile;
      int nrows = NX;
      if (c >= ns_tiles && hb != nullptr) {
        src = hb;
        row0 = static_cast<long long>(c - ns_tiles) * cgc::kTile;
        nrows = NH;
      }
      const bool nz = a[0] != 0.f || a[1] != 0.f || a[2] != 0.f || a[3] != 0.f;
      for (unsigned bal = __ballot_sync(kFull, nz); bal; bal &= bal - 1) {
        const int l = __ffs(bal) - 1;
        sum.reserve(4, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __shfl_sync(kFull, a[e], l);
          const long long xr = row0 + 4 * l + e;
          if (v != 0.f && xr >= 0 && xr < nrows) sum.add(src + xr * F, v, lane);
        }
      }
    }
    sum.flush(lane);

    // acc / split outputs and the epilogue take B == 1 (the wrapper checks)
    float sc = 0.f, sf = 0.f;
    if (sw != nullptr) {
      sc = cgc::to_f32(sw[row * 128]);
      sf = cgc::to_f32(sw[row * 128 + 1]);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = v0 + lane + 32 * j;
      if (vi >= nvec) continue;
      const long long f = static_cast<long long>(vi) * VEC;
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = sum.acc[j][e];
      if (acc != nullptr) {
        if (row < NA) {
          float av[VEC];
          cgc::load_vec<T, VEC>(av, acc + row * F + f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = v[e] + av[e];
          cgc::gather::store_vec<T, VEC>(out + row * F + f, v);
        } else {
          cgc::gather::store_vec<T, VEC>(out_tail + (row - NA) * F + f, v);
        }
        continue;
      }
      if (sw != nullptr) {
        float xv[VEC];
        cgc::load_vec<T, VEC>(xv, xb + row * F + f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = sc * v[e] + sf * xv[e];
      }
      cgc::gather::store_vec<T, VEC>(out + (b * rows_b + row) * F + f, v);
    }
  }
}

// the widest vector that F and every row base allow (x, the halo, acc and
// the outputs); block rows are read 4 values a lane (vals aligned to 4)
template <typename V, typename T>
cudaError_t launch(const void* vals, const int* blk_cols, const int* slots,
                   const void* x, const void* halo, const void* acc,
                   const void* sw, void* out, void* out_tail, int B, int R,
                   int M, int ns_tiles, int NX, int NH, int F, int NA,
                   cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * R * cgc::kTile;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  if (reinterpret_cast<uintptr_t>(vals) % (4 * sizeof(V)) != 0)
    return cudaErrorMisalignedAddress;
  const int vec = cgc::gather::rows_vec<T>(F, {x, halo, acc, out, out_tail});
  return cgc::with_vec<T>(vec, [&](auto e) {
    constexpr int E = decltype(e)::value;
    return cgc::gather::with_nv(F / E, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      if (blocks > 0 && F > 0) {
        banded_kernel<V, T, E, NV><<<blocks, kThreads, 0, s>>>(
            static_cast<const V*>(vals), blk_cols, slots,
            static_cast<const T*>(x), static_cast<const T*>(halo),
            static_cast<const T*>(acc), static_cast<const T*>(sw),
            static_cast<T*>(out), static_cast<T*>(out_tail), B, R, M,
            ns_tiles, NX, NH, F, NA);
      }
      return cudaGetLastError();
    });
  });
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
// kI8. bf16 at F >= 128 takes the tensor-core kernel (F even), everything
// else the gather kernel; both stop at live_slots where it is given.
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
      return i8 ? launch<int8_t, float>(vals, bc, slots, x, halo, acc,
                                        epilogue_sw, out, out_tail, B, R, M,
                                        ns_tiles, NX, NH, F, NA, s)
                : launch<float, float>(vals, bc, slots, x, halo, acc,
                                       epilogue_sw, out, out_tail, B, R, M,
                                       ns_tiles, NX, NH, F, NA, s);
    case cgc::kBF16:
      if (F >= 128)
        return i8 ? launch_tc<int8_t>(vals, bc, slots, x, halo, acc,
                                      epilogue_sw, out, out_tail, B, R, M,
                                      ns_tiles, NX, NH, F, NA, s)
                  : launch_tc<bf16>(vals, bc, slots, x, halo, acc,
                                    epilogue_sw, out, out_tail, B, R, M,
                                    ns_tiles, NX, NH, F, NA, s);
      return i8 ? launch<int8_t, __nv_bfloat16>(
                      vals, bc, slots, x, halo, acc, epilogue_sw, out,
                      out_tail, B, R, M, ns_tiles, NX, NH, F, NA, s)
                : launch<__nv_bfloat16, __nv_bfloat16>(
                      vals, bc, slots, x, halo, acc, epilogue_sw, out,
                      out_tail, B, R, M, ns_tiles, NX, NH, F, NA, s);
    default:
      return cudaErrorInvalidValue;
  }
}
