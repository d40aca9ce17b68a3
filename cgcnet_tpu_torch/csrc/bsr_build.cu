// B1 — block build of the stage-1 adjacency.
//
// Replaces cgcnet_tpu/ops/pallas/bsr_kernel.py: bsr_build_blocks
// (_build_blocks_kernel). vals[b, r, m] is the dense 128x128 block of A at
// row tile r and column tile blk_cols[b, r, m], built from the ELL slots
// (nbr, w): A[i, nbr[i, k]] += w[i, k]. Padded block slots (blk_mask 0)
// come out all zero, duplicate columns of one row sum, and the sum runs over
// k in slot order from 0.0, as the TPU kernel's compare-accumulate does, so
// f32 results are bit-equal. The slide path asks for int8 blocks (its
// operator is binary): the f32 sums are truncated to int8 on the store.
//
// Bound on the H100: bytes — the values written, B*R*M*128*128 of them
// (71 MB of f32 at the canonical B=4, R=45, M=6; ~120 MB of int8 at the
// slide's 784 row tiles), beside which the ELL slice is small. Design: a
// warp builds one row group — P rows of a row tile (P = 4 / sizeof(T): 1
// in f32, 2 in bf16, 4 in int8) — in all M slots, reading the rows' ELL
// slots once, one per lane (chunks of 32 for any K; two chunks held in
// registers, the rest read again per slot through L1). Per slot, each
// lane whose ELL slot falls in the slot's column tile puts its weight into
// the warp's own copy of the P rows in shared memory (f32, all zero
// between slots); a row that names one column twice (one __match_any_sync
// per row group tells) adds its weights there one lane at a time, in slot
// order, so every column holds the plain version's sum in its order and
// no atomics are needed. Each lane then reads back 16 / sizeof(T)
// consecutive columns of one row (zeroing them; rows padded and the
// lanes' rows interleaved against bank conflicts), rounds or truncates
// them to T and stores them as one 16-byte vector: the warp's store covers
// P whole rows. A dead slot is written as zeros with the same stores, its
// ELL scan skipped. The TPU kernel's grid is (b, r), a program per
// row tile; here the warps of a grid the card holds at once walk the row
// groups of every tile (a block per row tile left the patch's 180 tiles
// on 132 SMs unevenly, and the slide's 784 over one and a half waves). No
// shared tile (the warp's rows are P x 528 bytes), no zeroing pass, no
// __syncthreads, no per-launch attribute (the card's resident blocks are
// asked once per device).

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {

// f(std::integral_constant<int, I>) for I = 0 .. N-1: the index is a
// constant in each call (decltype(arg)::value), so arrays indexed by it
// stay in registers.
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 2;  // chunks of 32 ELL slots a lane holds

// 16 / sizeof(T) values rounded to T (int8: truncated) as one 16-byte
// vector, in column order.
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&v)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&x);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ uint4 pack16<int8_t>(const float (&v)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = static_cast<uint32_t>(cgc::from_f32<int8_t>(v[4 * e + i]));
    // the low bytes of q0 .. q3, in column order
    w[e] = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                       __byte_perm(q[2], q[3], 0x0040), 0x5410);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) build_blocks_kernel(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const int* __restrict__ blk_cols, const float* __restrict__ blk_mask,
    T* __restrict__ vals, int B, int N, int K, int R, int M) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // values a store
  constexpr int P = 4 / static_cast<int>(sizeof(T));   // rows a warp store
  constexpr int kGroups = cgc::kTile / P;  // row groups of a row tile
  // the warp's P rows of one slot, in f32, all zero between slots; rows
  // kPitch apart and the lanes' rows interleaved, so that the 16-byte
  // reads of a quarter warp meet eight different groups of banks
  constexpr int kPitch = cgc::kTile + 4;
  __shared__ __align__(16) float s_rows[kWarps][P][kPitch];
  float(*rows)[kPitch] = s_rows[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int sub = lane % P, j = lane / P;  // the lane's store: row, vector
  const int nch = (K + 31) / 32;
  for (int e = lane; e < P * kPitch / 4; e += 32)
    reinterpret_cast<float4*>(rows)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  const long long items = static_cast<long long>(B) * R * kGroups;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long item = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
       item < items; item += step) {
    const long long br = item / kGroups;  // b * R + r
    const int g = static_cast<int>(item % kGroups);
    const long long b = br / R;
    const int r = static_cast<int>(br % R);
    // the P rows' ELL slots, slot c * 32 + lane of each, and whether a row
    // names one column in two slots of nonzero weight (a row of more than
    // one chunk is taken as if it did)
    long long ell[P];
    int nb[P][kChunks];
    float wv[P][kChunks];
    bool dup[P];
    static_for<0, P>([&](auto row) {
      constexpr int pp = decltype(row)::value;
      ell[pp] = (b * N + static_cast<long long>(r) * cgc::kTile + g * P + pp) *
                K;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int k = 32 * c + lane;
        nb[pp][c] = k < K ? nbr[ell[pp] + k] : -1;
        wv[pp][c] = k < K ? w[ell[pp] + k] : 0.f;
      }
      const int key = wv[pp][0] != 0.f
                          ? nb[pp][0]
                          : static_cast<int>(0x80000000u | lane);  // unique
      const unsigned same = __match_any_sync(0xffffffffu, key);
      dup[pp] =
          nch > 1 || __ballot_sync(0xffffffffu, __popc(same) > 1) != 0;
    });
    for (int m = 0; m < M; ++m) {
      const long long slot = br * M + m;
      uint4* out = reinterpret_cast<uint4*>(
                       vals + (slot * cgc::kTile + g * P + sub) * cgc::kTile) +
                   j;
      const float bm = truncf(blk_mask[slot]);  // an integer mask
      if (bm == 0.f) {
        *out = make_uint4(0, 0, 0, 0);
        continue;
      }
      const int tb = blk_cols[slot] * cgc::kTile;
      // each row's slots in the column tile into its row, in slot order: a
      // row without a repeated column stores each weight at once (0 + w is
      // w); one with adds them one lane at a time. A slot of weight 0 adds
      // nothing (the sums never hold -0) and is skipped.
      static_for<0, P>([&](auto row) {
        constexpr int pp = decltype(row)::value;
        if (!dup[pp]) {
          const int col = nb[pp][0] - tb;
          if (static_cast<unsigned>(col) < cgc::kTile && wv[pp][0] != 0.f)
            rows[pp][col] = wv[pp][0];
          return;
        }
        for (int c = 0; c < nch; ++c) {
          int nbc = -1;
          float wc = 0.f;
          if (c < kChunks) {
#pragma unroll
            for (int q = 0; q < kChunks; ++q)
              if (q == c) nbc = nb[pp][q], wc = wv[pp][q];
          } else {
            const int k = 32 * c + lane;
            nbc = k < K ? nbr[ell[pp] + k] : -1;
            wc = k < K ? w[ell[pp] + k] : 0.f;
          }
          const int col = nbc - tb;
          unsigned hit = __ballot_sync(
              0xffffffffu,
              static_cast<unsigned>(col) < cgc::kTile && wc != 0.f);
          while (hit) {
            const int s = __ffs(hit) - 1;
            hit &= hit - 1;
            if (lane == s) rows[pp][col] += wc;
            __syncwarp();
          }
        }
      });
      __syncwarp();
      // this lane's V columns of row ``sub``, read and zeroed again
      float v[V];
      float4* mine = reinterpret_cast<float4*>(rows[sub] + j * V);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 x = mine[q];
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
        mine[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (bm != 1.f) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] *= bm;
      }
      *out = pack16<T>(v);
      __syncwarp();  // zeroed before the next slot's weights land
    }
  }
}

// As many blocks as the card holds at once (asked once per device), each
// warp walking row groups item, item + the grid's warps, ...
template <typename T>
cudaError_t launch(const int* nbr, const float* w, const int* blk_cols,
                   const float* blk_mask, void* vals, int B, int N, int K,
                   int R, int M, int device, cudaStream_t stream) {
  const long long items =
      static_cast<long long>(B) * R * (cgc::kTile / (4 / sizeof(T)));
  if (items == 0 || M == 0) return cudaGetLastError();
  static std::mutex mu;
  static int fit_device = -1;
  static long long resident = 0;
  long long blocks;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (fit_device != device) {
      int sms, per_sm;
      cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, build_blocks_kernel<T>, kThreads, 0);
      if (err != cudaSuccess) return err;
      fit_device = device;
      resident = static_cast<long long>(sms) * per_sm;
    }
    blocks = resident;
  }
  blocks = std::min(blocks, (items + kWarps - 1) / kWarps);
  build_blocks_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(nbr, w, blk_cols, blk_mask,
                                     static_cast<T*>(vals), B, N, K, R, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cgc_bsr_build_blocks(const void* nbr, const void* w,
                                    const void* blk_cols, const void* blk_mask,
                                    void* vals, int B, int N, int K, int R,
                                    int M, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto n = static_cast<const int*>(nbr);
  auto ww = static_cast<const float*>(w);
  auto bc = static_cast<const int*>(blk_cols);
  auto bm = static_cast<const float*>(blk_mask);
  switch (dtype) {
    case cgc::kF32:
      return launch<float>(n, ww, bc, bm, vals, B, N, K, R, M, device, s);
    case cgc::kBF16:
      return launch<__nv_bfloat16>(n, ww, bc, bm, vals, B, N, K, R, M,
                                   device, s);
    case cgc::kI8:
      return launch<int8_t>(n, ww, bc, bm, vals, B, N, K, R, M, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
