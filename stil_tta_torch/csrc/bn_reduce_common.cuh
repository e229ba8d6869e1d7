// Shared pieces of the BatchNorm reduction kernels: the block size and
// the 16-byte load types; the launch plan and the two ends of the
// one-launch column reduction that bn_stats.cu and bn_bwd_reduce.cu
// share (a block's partial row of 2*C floats a row chunk, and the
// fixed-order combine of those rows after grid.sync(); the ring walk in
// between is bn_reduce_ring.cuh); and the separate fixed-order second
// pass over per-block partial rows that the conv kernels launch
// (conv_chain_common.cuh).
//
// The plan is the wrapper's (stil_tta_torch/ops/batch_norm.py:
// stats_plan, bwd_plan): column tiles of at most 256 channels x row
// chunks of a contiguous row range, kThreads threads a block, threads
// along a tile's channels reading VEC values each.

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

// Mirrors ops/batch_norm.py:ReducePlan.
struct Plan {
  int64_t m;
  int c;
  int tile_c;          // channels of a column tile (a multiple of vec)
  int tiles;
  int stage_rows;      // rows of a ring stage (vec > 1)
  int stages;          // ring depth (vec > 1)
  int stage_pitch;     // bytes from one stage to the next, all inputs
  int64_t rows_per_chunk;
  int chunks;          // row chunks = rows of the partial buffer
  int combine_cols;    // output columns a block adds at once
};

// Adds the block's row lanes in order and writes the item's partial row:
// partial[chunk] = [first sums | second sums], each C wide, at the tile's
// columns. Thread (tx, ty) holds s[VEC], q[VEC] for channels tx*VEC.. of
// the tile; scratch holds 2 * kThreads * VEC floats (it reuses the ring).
template <int VEC>
__device__ __forceinline__ void write_partial(
    const float (&s)[VEC], const float (&q)[VEC], bool active, int tx,
    int ty, int rows_per_step, const Plan& p, int col0, int width,
    int chunk, float* scratch, float* __restrict__ partial) {
  const int tid = threadIdx.x;
  float* sh_q = scratch + rows_per_step * p.tile_c;
  __syncthreads();  // the ring (or the last item's scratch) is free
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      scratch[ty * p.tile_c + tx * VEC + i] = s[i];
      sh_q[ty * p.tile_c + tx * VEC + i] = q[i];
    }
  }
  __syncthreads();
  float* row = partial + static_cast<int64_t>(chunk) * 2 * p.c + col0;
  for (int col = tid; col < width; col += kThreads) {
    float ts = 0.f, tq = 0.f;
#pragma unroll 8
    for (int t = 0; t < rows_per_step; ++t) {
      ts += scratch[t * p.tile_c + col];
      tq += sh_q[t * p.tile_c + col];
    }
    row[col] = ts;
    row[p.c + col] = tq;
  }
  // the ring's next bulk copies (the async proxy) land where these
  // threads just wrote
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// After grid.sync(): out[j] = sum over the row chunks k of partial[k][j],
// for the 2*C columns j. A block takes combine_cols (a power of two up to
// kThreads) consecutive columns at a time: thread t adds column
// t % combine_cols over k = t / combine_cols + i * kThreads / combine_cols
// in order. A column's threads then meet in a fixed order: below 32
// columns, in a shuffle tree inside each warp and then warp by warp; from
// 32 on (each warp holds distinct columns), in the order of t.
__device__ __forceinline__ void combine(const Plan& p,
                                        const float* partial, float* out,
                                        float* scratch) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cols = p.combine_cols, lanes = kThreads / cols;
  const int col = tid % cols, kl = tid / cols;
  const bool narrow = cols < 32;
  const int slots = narrow ? kThreads / 32 : lanes;
  const int width = 2 * p.c;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * cols; g < width;
       g += static_cast<int64_t>(gridDim.x) * cols) {
    const int64_t j = g + col;
    float v = 0.f;
    if (j < width) {  // four loads in flight, added in k order
      for (int k = kl; k < p.chunks; k += 4 * lanes) {
        float t[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ku = k + u * lanes;  // L2 only: written in this launch
          t[u] = ku < p.chunks
                     ? __ldcg(partial + static_cast<int64_t>(ku) * width + j)
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) v += t[u];
      }
    }
    if (narrow) {
      for (int off = 16; off >= cols; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane < cols) scratch[warp * cols + col] = v;
    } else {
      scratch[kl * cols + col] = v;
    }
    __syncthreads();
    if (tid < cols && j < width) {
      float t = 0.f;
      for (int w = 0; w < slots; ++w) t += scratch[w * cols + tid];
      out[j] = t;
    }
    __syncthreads();
  }
}

// The conv kernels' second pass. partial is (chunks, width); out is
// (width,). Block (32, kFinalLanes): 32 columns per block, eight lanes
// over interleaved chunks, then the eight lane sums in order.
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

}  // namespace bn_reduce
