// Hopper tensor-core building blocks of the bf16 kernels (B8, and B4 / B6 /
// B9a's product): asynchronous copies into shared memory, the warpgroup
// product wgmma m64n192k16 with A in registers and B in 128-byte-swizzled
// shared memory, its shared-memory descriptor, and the warp-level
// mma.sync m16n8k16 (the 20-deep product forming p, B2's block
// products), and the routines that form conv3's lin output p on the
// tensor cores (``lin_p_mma``) and its row norm (``lin_rnorm``) for B9a's
// two kernels and for B9b.
//
// Fragment layouts (g = lane / 4, t = lane % 4; warp w of a warpgroup owns
// rows 16w .. 16w + 15 of the warpgroup's 64):
//   A (16 x 16 per warp, bf16 pairs, low half = lower column):
//     a[0] = (g, 2t..2t+1)  a[1] = (g+8, 2t..)  a[2] = (g, 2t+8..)
//     a[3] = (g+8, 2t+8..)  — the same for wgmma's register operand and for
//     mma.sync's A;
//   wgmma accumulator of m64nN: d[4j + 2h + e] = (g + 8h, 8j + 2t + e);
//   mma.sync accumulator of m16n8: c[2h + e] = (g + 8h, 2t + e); its B
//     operand b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g).
//
// B operand layout ("MN-major", 128-byte swizzle): a [K x 64] bf16 atom
// keeps row k's 128 bytes at k * 128, its 16-byte chunk q at chunk
// q ^ (k % 8); the atom starts on a 1024-byte boundary. A tile wider than 64
// columns is a row of atoms LBO bytes apart; 8-row groups are SBO = 1024
// bytes apart.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cgc {
namespace tc {

constexpr int kN = 192;  // wgmma N: columns of one product tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 column ``col`` (0 .. kN-1) of row ``k`` in a row of
// atoms ``atom_bytes`` apart.
__device__ __forceinline__ uint32_t swz_offset(int k, int col,
                                               uint32_t atom_bytes) {
  const int byte = col * 2;
  const int atom = byte >> 7, chunk = (byte >> 4) & 7;
  return atom * atom_bytes + k * 128 + ((chunk ^ (k & 7)) << 4) + (byte & 15);
}

// Copy VEC bytes (4, 8 or 16) from global to shared memory, asynchronously;
// !valid fills the VEC bytes with zeros and reads nothing.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? VEC : 0;
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(VEC), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight, then make this
// thread's landed copies visible to the tensor cores' (async proxy) reads;
// a __syncthreads() must follow before other threads' copies are read.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of an MN-major, 128-byte-swizzled B operand at shared address
// ``saddr`` (1024-byte aligned): LBO = bytes between atoms, SBO = bytes
// between 8-row groups.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t saddr,
                                                  uint32_t lbo,
                                                  uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous product (call after wgmma_wait, before they are read).
__device__ __forceinline__ void fence_acc(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 192] += A[64 x 16] (registers, bf16) @ B[16 x 192] (shared,
// MN-major, descriptor ``desc_b``), f32 accumulation; one warpgroup.
__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[96],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// c[16 x 8] += A[16 x 16] @ B[16 x 8], bf16 in, f32 sums; one warp.
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 b;
  *reinterpret_cast<uint32_t*>(&b) = v;
  return __bfloat1622float2(b);
}

// ldmatrix .trans of two (x2) or four (x4) 8 x 8 b16 matrices whose rows
// lanes 0-7, 8-15 (, 16-23, 24-31) address: B operands of mma.sync
// m16n8k16 (pairs along k) from a row-major [k][n] tile in shared memory.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// ---- conv3's lin output p on the tensor cores (B9a) ----
//
// p = round_bf16(round_bf16(x3 . kc3[:, c]) + b3[c]): the x3 rows, padded to
// kF3Pad columns with zeros, are the A operand (two k-steps of 16), kc3^T
// ([round_up(C, 64), kF3Pad], zero-padded: ops/assign_head.py
// pad_lin_kernel) the B operand; the f32 accumulator of each 16 x 8 tile is
// rounded, the bias added and rounded again. B9a's row norm and product
// and B9b's statistics form p through these routines, so all see the same
// p, bit for bit.
constexpr int kF3Pad = 32;               // x3 width: two k-steps
constexpr int kLStride = kF3Pad * 2 + 16;  // a kc3^T row staged in shared
                                           //   memory: 80 bytes

// The x3 rows ``ra`` and ``ra + 8`` (flat rows of an [rows, F3] array) as
// the A fragments of both k-steps; columns past F3 are zeros.
__device__ __forceinline__ void lin_x3_frags(uint32_t (&xf)[2][4],
                                             const __nv_bfloat16* x3,
                                             long long ra, int F3, int tq) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = ra + (i % 2) * 8;
      const int k = 16 * kk + 2 * tq + (i / 2) * 8;
      __nv_bfloat162 v;
      v.x = k < F3 ? x3[row * F3 + k] : zero;
      v.y = k + 1 < F3 ? x3[row * F3 + k + 1] : zero;
      xf[kk][i] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// The B operand of one 16 x 8 tile of p: the kc3^T row at ``brow``
// (column 2*tq of row n0 + g; any row stride, shared or global memory), as
// the fragments of both k-steps.
__device__ __forceinline__ void lin_b_frags(
    uint32_t (&bf)[4], const __nv_bfloat16* __restrict__ brow) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    bf[2 * kk] = *reinterpret_cast<const uint32_t*>(brow + 16 * kk);
    bf[2 * kk + 1] = *reinterpret_cast<const uint32_t*>(brow + 16 * kk + 8);
  }
}

// p of one warp's 16 rows x 8 columns from the x3 fragments ``xf`` and the
// kc3^T fragments ``bf`` (lin_b_frags); ``bb0`` / ``bb1`` are b3 at columns
// n0 + 2tq and + 1 (0 past C). p[2h + e] is row g + 8h, column n0 + 2tq + e
// — the layout of the mma.sync accumulator.
__device__ __forceinline__ void lin_p_frag(float (&p)[4],
                                           const uint32_t (&xf)[2][4],
                                           const uint32_t (&bf)[4], float bb0,
                                           float bb1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    mma_m16n8k16(c, xf[kk], bf[2 * kk], bf[2 * kk + 1]);
  // each rounding to bf16 (round to nearest even) two values at a time
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 r = unpack_bf16(pack_bf16(c[2 * h], c[2 * h + 1]));
    const float2 q = unpack_bf16(pack_bf16(r.x + bb0, r.y + bb1));
    p[2 * h] = q.x;
    p[2 * h + 1] = q.y;
  }
}

// lin_b_frags then lin_p_frag: p of one 16 x 8 tile with its kc3^T row
// read at ``brow``.
__device__ __forceinline__ void lin_p_mma(
    float (&p)[4], const uint32_t (&xf)[2][4],
    const __nv_bfloat16* __restrict__ brow, float bb0, float bb1) {
  uint32_t bf[4];
  lin_b_frags(bf, brow);
  lin_p_frag(p, xf, bf, bb0, bb1);
}

// The row norm of B9a and B9b: rn = 1 / max(||p||, 1e-12) of rows g and
// g + 8 of the 16-row group whose x3 fragments are ``xf``, p formed by
// lin_p_mma over the columns [0, C) from kc3^T (``kc3t``, rows ``stride``
// elements apart; shared or global memory) and b3. Each lane sums the
// squares of its two columns of every 8-column tile, tiles in ascending
// order, as one fmaf chain per row; the row's four lanes (tq) then add
// their sums by xor-shuffle. Every lane returns its rows' rn. The
// statistics (B9b) and the head (B9a) normalize by this one routine, so
// they see the same h, bit for bit.
__device__ __forceinline__ void lin_rnorm(
    float& rn0, float& rn1, const uint32_t (&xf)[2][4],
    const __nv_bfloat16* __restrict__ kc3t, int stride,
    const __nv_bfloat16* __restrict__ b3, int C, int lane) {
  const int g = lane / 4, tq = lane % 4;
  float ss0 = 0.f, ss1 = 0.f;
  for (int jn = 0; jn < (C + 7) / 8; ++jn) {
    const int col = 8 * jn + 2 * tq;
    float p[4];
    lin_p_mma(p, xf, kc3t + (8 * jn + g) * stride + 2 * tq,
              col < C ? __bfloat162float(b3[col]) : 0.f,
              col + 1 < C ? __bfloat162float(b3[col + 1]) : 0.f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= C) continue;
      ss0 = fmaf(p[e], p[e], ss0);
      ss1 = fmaf(p[2 + e], p[2 + e], ss1);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    ss0 += __shfl_xor_sync(0xffffffffu, ss0, o);
    ss1 += __shfl_xor_sync(0xffffffffu, ss1, o);
  }
  rn0 = 1.f / fmaxf(sqrtf(ss0), 1e-12f);
  rn1 = 1.f / fmaxf(sqrtf(ss1), 1e-12f);
}

// Largest copy width (16, 8 or 4 bytes) that every bf16 row of ``cols``
// columns and every base address allows; 0 if none (an odd width).
__host__ __forceinline__ int copy_width(int cols, const void* p0,
                                        const void* p1 = nullptr) {
  for (int vec = 16; vec >= 4; vec /= 2) {
    const bool ok =
        (cols * 2) % vec == 0 &&
        reinterpret_cast<uintptr_t>(p0) % vec == 0 &&
        (p1 == nullptr || reinterpret_cast<uintptr_t>(p1) % vec == 0);
    if (ok) return vec;
  }
  return 0;
}

}  // namespace tc
}  // namespace cgc
