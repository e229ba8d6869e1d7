// Shared pieces of the fused 1x1-conv kernels (conv_chain.cu and
// conv_bwd_join.cu): tile layout, the copy of a bfloat16 matrix into
// padded shared memory, the tensor-core product of one warp's 16-row
// strip, and the block's fixed-order partial sums.
//
// Both kernels run persistent blocks of kWarps warps over tiles of kRows
// rows. A block keeps the whole weight in shared memory, stages a tile of
// the left operand there, and each warp multiplies its 16-row strip by the
// weight with nvcuda::wmma 16x16x16 bf16 products accumulated in float32.
// Each finished 16x16 accumulator goes through a per-warp float32 staging
// square, from which the kernel's epilogue reads it: lane (cp, rg) = (lane
// % 8, lane / 8) takes the column pair 2*cp, 2*cp + 1 of rows rg, rg + 4,
// rg + 8, rg + 12. Column sums go from the lanes (two shuffles, fixed
// order) into per-warp float32 accumulators in shared memory, then into
// one partial row per block, and bn_reduce::column_sums_kernel sums the
// rows in a fixed order: no float atomics, so two launches on the same
// input give bitwise-equal results.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "bn_reduce_common.cuh"

namespace conv_chain_common {

using namespace nvcuda;

constexpr int kRows = 64;              // rows of a tile
constexpr int kWarps = kRows / 16;     // one 16-row strip per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 pad of each shared row
constexpr int kGroup = 4;              // accumulators a warp holds at once
constexpr int kStage = 16 * 16;        // floats of a warp's staging square

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst[r * ld + c] = src[r * cols + c] for a (rows, cols) row-major matrix,
// cols % 8 == 0, by 16-byte units over the block's threads.
__device__ __forceinline__ void copy_to_shared(bf16* dst, int ld,
                                               const bf16* __restrict__ src,
                                               int rows, int cols) {
  const int units = cols / 8;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int r = i / units, c = (i % units) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = s[i];
  }
}

// The product of a warp's 16-row strip a (row-major, lda) with the (k, n)
// right operand b in shared memory: row-major b[kk * ldb + j] when
// B_ROW_MAJOR, else column-major b[j * ldb + kk] (a transposed row-major
// (n, k) matrix). For each 16-column block j it stores the float32
// accumulator into the warp's staging square and calls epilogue(col).
template <bool B_ROW_MAJOR, typename Epilogue>
__device__ __forceinline__ void strip_product(const bf16* a, int lda,
                                              const bf16* b, int ldb, int k,
                                              int n, float* stage,
                                              Epilogue epilogue) {
  using BLayout =
      typename std::conditional<B_ROW_MAJOR, wmma::row_major,
                                wmma::col_major>::type;
  for (int n0 = 0; n0 < n; n0 += 16 * kGroup) {
    const int nf = min(kGroup, (n - n0) / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < k; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + k0, lda);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < nf) {
          const int col = n0 + 16 * j;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
          wmma::load_matrix_sync(
              fb, B_ROW_MAJOR ? b + k0 * ldb + col : b + col * ldb + k0, ldb);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < nf) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        epilogue(n0 + 16 * j);
        __syncwarp();
      }
    }
  }
}

// Adds v over the four lanes that share a column pair (lane % 8), in a
// fixed order; every lane ends with the total.
__device__ __forceinline__ float sum_row_groups(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// End of the block: partial[blockIdx.x * width + i] = the sum over warps,
// in warp order, of acc[w * width + i].
__device__ __forceinline__ void write_partial_row(const float* acc,
                                                  int width,
                                                  float* __restrict__ partial) {
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += acc[w * width + i];
    partial[static_cast<int64_t>(blockIdx.x) * width + i] = t;
  }
}

// Shared-memory size check, the attribute for more than 48 KB, and the
// grid: one block for each tile, at most as many as fit on the card at
// once and at most max_blocks (the rows of the partial buffer).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int64_t m,
                            int max_blocks, int* grid) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (m + kRows - 1) / kRows;
  int64_t g = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (g > max_blocks) g = max_blocks;
  if (g > tiles) g = tiles;
  *grid = static_cast<int>(g);
  return cudaSuccess;
}

// Pass 2 over the (grid, width) partial rows into out (width,).
inline cudaError_t column_sums(const float* partial, int rows, int width,
                               float* out, cudaStream_t stream) {
  const dim3 block(32, bn_reduce::kFinalLanes);
  bn_reduce::column_sums_kernel<<<(width + 31) / 32, block, 0, stream>>>(
      partial, rows, width, out);
  return cudaGetLastError();
}

}  // namespace conv_chain_common
