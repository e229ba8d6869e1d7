// BatchNorm backward reduction: per channel, sum(dy) and
// sum(dy * x_hat) with x_hat = (x - mean) * inv recomputed from the saved
// activation, over the rows of row-major (M, C) x and dy, in float32.
//
// Replaces the Pallas TPU kernel stil_tta_tpu/ops/batch_norm.py:
// bn_bwd_reduce (_bwd_kernel), the reduction inside bn_train's custom VJP.
// That kernel carries its two sums across a sequential grid of row tiles.
// Here, as in bn_stats.cu and with the same partial-sum layout:
//
//   pass 1 (bn_bwd_partial_kernel): the grid is channel tiles x row
//     chunks. Threads lie along C and read 16 bytes of x and 16 of dy per
//     row (8 bf16 or 4 f32 values each); at C = 64 bf16 a warp covers
//     four consecutive rows, so each warp reads 512 contiguous bytes of
//     each input. Each thread keeps its channels' mean and inv in
//     registers, walks its rows with float32 accumulators (two rows of
//     both inputs in flight), and the block reduces across its row lanes
//     through shared memory in a fixed order into one partial row of
//     (chunks, 2, C) float32 scratch.
//   pass 2 (bn_reduce::column_sums_kernel): each output column sums its
//     partials in a fixed order.
//
// No float atomics: two runs on the same input give bitwise-equal
// results. Any M: the last chunk and the loop tails take ragged rows.
//
// Bound: device-memory bandwidth. The kernel reads x and dy, 2*M*C*2
// bytes in bf16 (2*M*C*4 in f32), and writes 2*C floats; its 5 flops per
// element are far below what an H100 does per byte read. The design keeps
// 16-byte coalesced loads of both inputs and about eight blocks per SM
// (the wrapper's launch_config, shared with bn_stats).

#include "bn_reduce_common.cuh"

namespace {

using bn_reduce::kThreads;
using bn_reduce::Load;

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(
    const typename Load<T, VEC>::Raw& raw_x,
    const typename Load<T, VEC>::Raw& raw_dy, const float (&mean)[VEC],
    const float (&inv)[VEC], float (&s)[VEC], float (&q)[VEC]) {
  float fx[VEC], fdy[VEC];
  Load<T, VEC>::unpack(raw_x, fx);
  Load<T, VEC>::unpack(raw_dy, fdy);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] += fdy[i];
    q[i] = fmaf(fdy[i], (fx[i] - mean[i]) * inv[i], q[i]);
  }
}

// threads_c threads cover one row of a channel tile (tile_c = threads_c *
// VEC channels); kThreads / threads_c rows are read per step.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ mean_in,
                      const float* __restrict__ inv_in, int64_t m, int c,
                      int threads_c, int64_t rows_per_chunk,
                      float* __restrict__ partial) {
  using Raw = typename Load<T, VEC>::Raw;

  const int tx = threadIdx.x % threads_c;
  const int ty = threadIdx.x / threads_c;
  const int rows_per_step = kThreads / threads_c;
  const int tile_c = threads_c * VEC;
  const int c0 = blockIdx.x * tile_c + tx * VEC;
  const int64_t row_begin = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
  const int64_t row_end =
      row_begin + rows_per_chunk < m ? row_begin + rows_per_chunk : m;

  float s[VEC], q[VEC], mean[VEC], inv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
    mean[i] = 0.f;
    inv[i] = 0.f;
  }
  if (c0 < c) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = mean_in[c0 + i];
      inv[i] = inv_in[c0 + i];
    }
    // c % VEC == 0 and c0 % VEC == 0, so rows index whole Raw units
    const Raw* bx = reinterpret_cast<const Raw*>(x) + c0 / VEC;
    const Raw* bdy = reinterpret_cast<const Raw*>(dy) + c0 / VEC;
    const int64_t row_raw = c / VEC;
    int64_t r = row_begin + ty;
    const int64_t stride = rows_per_step;
    // two rows of both inputs in flight, then accumulate in row order
    for (; r + stride < row_end; r += 2 * stride) {
      const Raw x0 = bx[r * row_raw];
      const Raw d0 = bdy[r * row_raw];
      const Raw x1 = bx[(r + stride) * row_raw];
      const Raw d1 = bdy[(r + stride) * row_raw];
      accumulate<T, VEC>(x0, d0, mean, inv, s, q);
      accumulate<T, VEC>(x1, d1, mean, inv, s, q);
    }
    for (; r < row_end; r += stride) {
      accumulate<T, VEC>(bx[r * row_raw], bdy[r * row_raw], mean, inv, s,
                         q);
    }
  }

  bn_reduce::write_partial_row<VEC>(s, q, tx, ty, tile_c, rows_per_step, c,
                                   partial);
}

template <typename T, int VEC>
void launch_partial(const void* x, const void* dy, const float* mean,
                    const float* inv, int64_t m, int c, int threads_c,
                    int chunks, int64_t rows_per_chunk, float* partial,
                    cudaStream_t stream) {
  const int tile_c = threads_c * VEC;
  const dim3 grid((c + tile_c - 1) / tile_c, chunks);
  bn_bwd_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, m, c,
      threads_c, rows_per_chunk, partial);
}

}  // namespace

// x, dy: (m, c) row-major, both float32 (is_bf16 = 0) or both bfloat16
// (is_bf16 = 1). mean, inv: c floats. vec: 16 / itemsize for 16-byte loads
// (x and dy 16-byte aligned, c % vec == 0), else 1. threads_c: a power of
// two <= 32. partial: chunks * 2 * c floats. out: 2 * c floats,
// [sum dy | sum dy * x_hat]. Returns cudaGetLastError().
extern "C" int bn_bwd_reduce_launch(const void* x, const void* dy,
                                    const void* mean, const void* inv,
                                    int is_bf16, long long m, int c, int vec,
                                    int threads_c, int chunks,
                                    long long rows_per_chunk, void* partial,
                                    void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const float* mu = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  if (is_bf16) {
    if (vec == 8) {
      launch_partial<__nv_bfloat16, 8>(x, dy, mu, iv, m, c, threads_c,
                                       chunks, rows_per_chunk, p, st);
    } else {
      launch_partial<__nv_bfloat16, 1>(x, dy, mu, iv, m, c, threads_c,
                                       chunks, rows_per_chunk, p, st);
    }
  } else {
    if (vec == 4) {
      launch_partial<float, 4>(x, dy, mu, iv, m, c, threads_c, chunks,
                               rows_per_chunk, p, st);
    } else {
      launch_partial<float, 1>(x, dy, mu, iv, m, c, threads_c, chunks,
                               rows_per_chunk, p, st);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(bn_reduce::launch_column_sums(
      p, chunks, c, static_cast<float*>(out), st));
}
