// Per-channel BatchNorm statistics: sum(x) and sum(x*x) over the rows of a
// row-major (M, C) activation, accumulated in float32.
//
// Replaces the Pallas TPU kernel stil_tta_tpu/ops/batch_norm.py:bn_stats
// (_stats_kernel). That kernel walks a sequential grid of row tiles and
// carries the two sums in its output block from step to step. Blocks on
// the GPU run in no order, so this kernel reduces in two passes instead:
//
//   pass 1 (bn_stats_partial_kernel): the grid is channel tiles x row
//     chunks. Threads lie along C and read 16 bytes each (8 bf16 or 4 f32
//     values); when a row is narrower than a warp's reach (C = 64 bf16 is
//     128 bytes) a warp covers several consecutive rows, so every warp
//     reads one contiguous span. Each thread walks its rows with float32
//     accumulators in registers, the block reduces across its row lanes
//     through shared memory in a fixed order, and writes one partial row
//     per chunk to a float32 scratch of shape (chunks, 2, C).
//   pass 2 (bn_reduce::column_sums_kernel, bn_reduce_common.cuh): each
//     output column sums its partials, eight lanes over interleaved
//     chunks, then the eight lane sums in order.
//
// No float atomics: every sum has a fixed order, so two runs on the same
// input give bitwise-equal results.
//
// Bound: device-memory bandwidth. The kernel reads M*C*2 bytes in bf16
// (M*C*4 in f32) and writes 2*C floats; its 3 flops per element are
// negligible beside that on an H100. The design keeps 16-byte coalesced
// loads and four loads in flight per thread, and the wrapper
// (stil_tta_torch/ops/batch_norm.py:launch_config) cuts the rows so about
// eight blocks per SM share the input. The second pass and the launch
// itself cost a few microseconds, which dominate the small late-stage
// shapes of ResNet-50.

#include "bn_reduce_common.cuh"

namespace {

using bn_reduce::kThreads;
using bn_reduce::Load;

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(
    const typename Load<T, VEC>::Raw& raw, float (&s)[VEC],
    float (&q)[VEC]) {
  float f[VEC];
  Load<T, VEC>::unpack(raw, f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] += f[i];
    q[i] = fmaf(f[i], f[i], q[i]);
  }
}

// threads_c threads cover one row of a channel tile (tile_c = threads_c *
// VEC channels); kThreads / threads_c rows are read per step.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, int64_t m, int c,
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

  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
  }
  if (c0 < c) {
    // c % VEC == 0 and c0 % VEC == 0, so rows index whole Raw units
    const Raw* base = reinterpret_cast<const Raw*>(x) + c0 / VEC;
    const int64_t row_raw = c / VEC;
    int64_t r = row_begin + ty;
    const int64_t stride = rows_per_step;
    // four loads in flight, then accumulate in row order
    for (; r + 3 * stride < row_end; r += 4 * stride) {
      const Raw v0 = base[r * row_raw];
      const Raw v1 = base[(r + stride) * row_raw];
      const Raw v2 = base[(r + 2 * stride) * row_raw];
      const Raw v3 = base[(r + 3 * stride) * row_raw];
      accumulate<T, VEC>(v0, s, q);
      accumulate<T, VEC>(v1, s, q);
      accumulate<T, VEC>(v2, s, q);
      accumulate<T, VEC>(v3, s, q);
    }
    for (; r < row_end; r += stride) {
      accumulate<T, VEC>(base[r * row_raw], s, q);
    }
  }

  bn_reduce::write_partial_row<VEC>(s, q, tx, ty, tile_c, rows_per_step, c,
                                   partial);
}

template <typename T, int VEC>
void launch_partial(const void* x, int64_t m, int c, int threads_c,
                    int chunks, int64_t rows_per_chunk, float* partial,
                    cudaStream_t stream) {
  const int tile_c = threads_c * VEC;
  const dim3 grid((c + tile_c - 1) / tile_c, chunks);
  bn_stats_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), m, c, threads_c, rows_per_chunk, partial);
}

}  // namespace

// x: (m, c) row-major, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
// vec: 16 / itemsize for 16-byte loads (x 16-byte aligned, c % vec == 0),
// else 1. threads_c: a power of two <= 32. partial: chunks * 2 * c floats.
// out: 2 * c floats, [sum | sum of squares]. Returns cudaGetLastError().
extern "C" int bn_stats_launch(const void* x, int is_bf16, long long m,
                               int c, int vec, int threads_c, int chunks,
                               long long rows_per_chunk, void* partial,
                               void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (is_bf16) {
    if (vec == 8) {
      launch_partial<__nv_bfloat16, 8>(x, m, c, threads_c, chunks,
                                       rows_per_chunk, p, st);
    } else {
      launch_partial<__nv_bfloat16, 1>(x, m, c, threads_c, chunks,
                                       rows_per_chunk, p, st);
    }
  } else {
    if (vec == 4) {
      launch_partial<float, 4>(x, m, c, threads_c, chunks, rows_per_chunk,
                               p, st);
    } else {
      launch_partial<float, 1>(x, m, c, threads_c, chunks, rows_per_chunk,
                               p, st);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(bn_reduce::launch_column_sums(
      p, chunks, c, static_cast<float*>(out), st));
}
