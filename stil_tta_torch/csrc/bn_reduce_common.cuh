// Shared pieces of the BatchNorm reduction kernels: the block size and
// the 16-byte load types (bn_stats.cu, bn_bwd_reduce.cu), and the second,
// fixed-order pass that sums each column's per-chunk partials
// (bn_bwd_reduce.cu, conv_chain_common.cuh; bn_stats.cu combines its
// partials inside its own single launch).
//
// bn_bwd_reduce cuts a row-major (M, C) input as the wrapper's
// stil_tta_torch/ops/batch_norm.py:launch_config says: a grid of channel
// tiles x row chunks, kThreads threads a block, threads along C reading
// VEC values each. Pass 1 writes one partial row of 2*C floats per chunk;
// pass 2 (column_sums_kernel) reduces the chunks column by column.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn_reduce {

constexpr int kThreads = 256;
constexpr int kFinalLanes = 8;

// Raw: the type one thread loads per step; unpack turns it into floats.
template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Load<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = r;
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p = __bfloat1622float2(h[k]);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
};

// Block-level end of pass 1: thread (tx, ty) holds a[VEC], b[VEC] for the
// channels tx*VEC.. of its tile. Sums over ty in a fixed order through
// shared memory and writes the chunk's partial row: partial[chunk] =
// [a | b], each C wide. tile_c * rows_per_step == kThreads * VEC.
template <int VEC>
__device__ __forceinline__ void write_partial_row(
    const float (&a)[VEC], const float (&b)[VEC], int tx, int ty,
    int tile_c, int rows_per_step, int c, float* __restrict__ partial) {
  __shared__ float sh_a[kThreads * VEC];
  __shared__ float sh_b[kThreads * VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh_a[ty * tile_c + tx * VEC + i] = a[i];
    sh_b[ty * tile_c + tx * VEC + i] = b[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < tile_c; col += kThreads) {
    const int ch = blockIdx.x * tile_c + col;
    float ta = 0.f, tb = 0.f;
    for (int t = 0; t < rows_per_step; ++t) {
      ta += sh_a[t * tile_c + col];
      tb += sh_b[t * tile_c + col];
    }
    if (ch < c) {
      float* out = partial + static_cast<int64_t>(blockIdx.y) * 2 * c;
      out[ch] = ta;
      out[c + ch] = tb;
    }
  }
}

// Pass 2. partial is (chunks, width) with width = 2*C; out is (width,).
// Block (32, kFinalLanes): 32 columns per block, eight lanes over
// interleaved chunks, then the eight lane sums in order.
__global__ void column_sums_kernel(const float* __restrict__ partial,
                                   int chunks, int width,
                                   float* __restrict__ out) {
  __shared__ float sh[kFinalLanes][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < width) {
    for (int k = threadIdx.y; k < chunks; k += kFinalLanes) {
      s += partial[static_cast<int64_t>(k) * width + col];
    }
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < kFinalLanes; ++y) t += sh[y][threadIdx.x];
    out[col] = t;
  }
}

inline cudaError_t launch_column_sums(const float* partial, int chunks,
                                      int c, float* out,
                                      cudaStream_t stream) {
  const int width = 2 * c;
  const dim3 block(32, kFinalLanes);
  column_sums_kernel<<<(width + 31) / 32, block, 0, stream>>>(
      partial, chunks, width, out);
  return cudaGetLastError();
}

}  // namespace bn_reduce
