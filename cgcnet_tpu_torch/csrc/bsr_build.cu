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
// Bound on the H100: bytes. The kernel writes B*R*M*128*128 values (71 MB of
// f32 at the canonical B=4, R=45, M=6) and reads the 128-row ELL slice once
// per block. Design: one thread block of 128 threads per (b, r, m) slot
// builds the tile in an f32 shared-memory buffer (64.5 KB, rows padded to
// 129 against bank conflicts): the threads zero it together, then thread i
// walks the K slots of row i in slot order and adds the weights whose
// column falls in the tile — one owner per row, so no atomics — and
// finally the threads copy the tile out row by row, each store a
// coalesced 128-value row.

#include "common.cuh"

namespace {

constexpr int kPitch = cgc::kTile + 1;
constexpr size_t kSmem = sizeof(float) * cgc::kTile * kPitch;

template <typename T>
__global__ void __launch_bounds__(cgc::kTile) build_blocks_kernel(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const int* __restrict__ blk_cols, const float* __restrict__ blk_mask,
    T* __restrict__ vals, int N, int K, int R, int M) {
  extern __shared__ float tile[];  // [kTile][kPitch]
  const long long slot = blockIdx.x;  // (b * R + r) * M + m
  const long long br = slot / M;
  const long long b = br / R;
  const int r = static_cast<int>(br % R);
  const int t = threadIdx.x;
  for (int i = 0; i < cgc::kTile; ++i) tile[i * kPitch + t] = 0.f;
  __syncthreads();

  // thread t owns row t of the tile: slots in order, from 0.0
  const long long ell = (b * N + static_cast<long long>(r) * cgc::kTile + t) * K;
  const int base = blk_cols[slot] * cgc::kTile;
  for (int k = 0; k < K; ++k) {
    const int c = nbr[ell + k] - base;
    if (c >= 0 && c < cgc::kTile) tile[t * kPitch + c] += w[ell + k];
  }
  __syncthreads();

  const float bm = blk_mask[slot];
  T* out = vals + slot * cgc::kTile * cgc::kTile;
  for (int i = 0; i < cgc::kTile; ++i) {
    out[i * cgc::kTile + t] = cgc::from_f32<T>(bm * tile[i * kPitch + t]);
  }
}

template <typename T>
cudaError_t launch(const int* nbr, const float* w, const int* blk_cols,
                   const float* blk_mask, void* vals, int B, int N, int K,
                   int R, int M, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      build_blocks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(B) * R * M;
  if (blocks > 0) {
    build_blocks_kernel<T><<<static_cast<unsigned>(blocks), cgc::kTile, kSmem,
                             stream>>>(nbr, w, blk_cols, blk_mask,
                                       static_cast<T*>(vals), N, K, R, M);
  }
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
      return launch<float>(n, ww, bc, bm, vals, B, N, K, R, M, s);
    case cgc::kBF16:
      return launch<__nv_bfloat16>(n, ww, bc, bm, vals, B, N, K, R, M, s);
    case cgc::kI8:
      return launch<int8_t>(n, ww, bc, bm, vals, B, N, K, R, M, s);
    default:
      return cudaErrorInvalidValue;
  }
}
