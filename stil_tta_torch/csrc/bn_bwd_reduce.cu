// BatchNorm backward reduction: per channel, sum(dy) and
// sum(dy * x_hat) with x_hat = (x - mean) * inv recomputed from the saved
// activation, over the rows of row-major (M, C) x and dy, in float32, in
// one launch.
//
// Replaces the Pallas TPU kernel stil_tta_tpu/ops/batch_norm.py:
// bn_bwd_reduce (_bwd_kernel), the reduction inside bn_train's custom VJP.
// That kernel carries its two sums across a sequential grid of row tiles.
// Blocks on the GPU run in no order, so here every block sums its own
// share and a fixed-order combine inside the same kernel adds the shares
// up: the two-input instance of bn_reduce_ring.cuh, whose one-input
// instance is bn_stats.cu.
//
// Bound: device-memory bandwidth. The kernel reads x and dy, 2*M*C*2
// bytes in bf16 (2*M*C*4 in f32), and mean and inv (2*C floats), and
// writes 2*C floats; its 5 flops an element are far below what the card
// computes per byte read. What the design does about each cost of the
// earlier two-kernel version (a partial pass on a grid of 132 * 8 blocks,
// then bn_reduce::column_sums_kernel):
//
// 1. Two launches a call -> one. The grid is launched cooperatively
//    (cudaLaunchCooperativeKernel): every block writes its partial rows,
//    then grid.sync(), then all blocks add the partial rows column by
//    column in a fixed order (bn_reduce::combine). No float atomics and
//    no counter that outlives the call: two launches on the same input
//    are bitwise equal, and two streams may run the kernel at once.
// 2. A slow second pass on 2C/32 blocks -> the combine runs on the whole
//    grid, each block taking combine_cols output columns at a time.
// 3. Too many partial rows at small M -> a persistent grid (the wrapper's
//    stil_tta_torch/ops/batch_norm.py:bwd_plan: the SM count times the
//    blocks an SM holds, bn_bwd_reduce_occupancy, at most two, capped at
//    the work) with one partial row of 2*C floats per row chunk, and a
//    least share of the input a block: the grid is at most the bytes of
//    x and dy over MIN_BLOCK_BYTES (32 KB, one ring stage of both
//    inputs), so a block writes at most 2 KB of partials (a 256-wide
//    tile) for every 32 KB it reads. At the batch-512 and batch-256
//    shapes the SM count binds first (at most 132 chunks, under 3% of the
//    input at 4,096 x 512); the least share binds at the 64- and 32-row
//    batches, where 132 blocks would read a few rows each.
// 4. Plain per-thread loads, two rows in flight -> a ring of four
//    shared-memory stages filled by the Tensor Memory Accelerator. A
//    stage holds the same stage_rows rows of x and of dy, 16 KB of each
//    (64 KB of each input in flight a block at one block an SM), brought
//    in by two bulk copies (cp.async.bulk of the contiguous span when a
//    tile is all of C, else 2-D cp.async.bulk.tensor boxes from two tensor
//    maps, for C > 256) counted on the stage's one mbarrier, armed with
//    expect_tx for both copies' bytes. Threads lie along the tile's
//    channels, 16 bytes of each input a thread; mean and inv of a
//    thread's channels stay in registers for the whole item. The variant
//    for unaligned pointers or rows that are not a multiple of 16 bytes
//    (vec = 1) reads both inputs directly with the same grid, row chunks
//    and combine.
// 5. A 4-byte spill of the bf16 VEC = 8 variant -> two rows of both
//    inputs in flight from shared memory (a few cycles away, not device
//    memory), 16 registers of loads beside 32 of sums, mean and inv.
//
// The order of every sum is fixed by the shape and the plan: a thread
// adds its rows in row order; a block adds its row lanes in order; in the
// combine, threads add interleaved row chunks in order, then meet in a
// fixed shuffle tree and in warp order.

#include "bn_reduce_ring.cuh"

namespace {

using bn_reduce::kThreads;
using bn_reduce::Load;

// Two inputs, x and dy: s += dy, q += dy * (x - mean) * inv, with the
// item's mean and inv in registers.
template <typename T, int VEC>
struct BwdOp {
  using Elem = T;
  static constexpr int kVec = VEC, kInputs = 2, kFlight = 2;
  using Raw = typename Load<T, VEC>::Raw;
  const float* mean_in;
  const float* inv_in;
  float mean[VEC], inv[VEC];

  __device__ __forceinline__ void begin(int ch, bool active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = active ? __ldg(mean_in + ch + i) : 0.f;
      inv[i] = active ? __ldg(inv_in + ch + i) : 0.f;
    }
  }

  __device__ __forceinline__ void add(const Raw (&v)[2], float (&s)[VEC],
                                      float (&q)[VEC]) const {
    float fx[VEC], fdy[VEC];
    Load<T, VEC>::unpack(v[0], fx);
    Load<T, VEC>::unpack(v[1], fdy);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] += fdy[i];
      q[i] = fmaf(fdy[i], (fx[i] - mean[i]) * inv[i], q[i]);
    }
  }
};

// VEC = 16 / sizeof(T): ring path; VEC = 1: direct loads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const __grid_constant__ bn_reduce::Inputs<2> in,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv, const bn_reduce::Plan p,
                     float* __restrict__ partial, float* __restrict__ out) {
  bn_reduce::reduce(in, BwdOp<T, VEC>{mean, inv}, p, partial, out);
}

template <typename T, int VEC>
const void* entry() {
  return reinterpret_cast<const void*>(bn_bwd_reduce_kernel<T, VEC>);
}

const void* kernel_for(int is_bf16, int vec) {
  if (is_bf16) {
    if (vec == 8) return entry<__nv_bfloat16, 8>();
    if (vec == 1) return entry<__nv_bfloat16, 1>();
  } else {
    if (vec == 4) return entry<float, 4>();
    if (vec == 1) return entry<float, 1>();
  }
  return nullptr;
}

}  // namespace

// The current device's SM count and how many blocks of the (is_bf16, vec)
// kernel with `smem` bytes of dynamic shared memory an SM holds: the
// wrapper's grid is at most their product (a cooperative launch needs
// every block resident). Returns a cudaError_t.
extern "C" int bn_bwd_reduce_occupancy(int is_bf16, int vec, int smem,
                                       int* sms, int* blocks_per_sm) {
  const void* kernel = kernel_for(is_bf16, vec);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bn_reduce::occupancy(kernel, smem, sms, blocks_per_sm));
}

// x, dy: (m, c) row-major, both float32 (is_bf16 = 0) or both bfloat16
// (is_bf16 = 1). mean, inv: c floats. vec: 16 / itemsize (x and dy
// 16-byte aligned, c % vec == 0), else 1. The plan (tile_c ..
// combine_cols, grid, smem) is ops/batch_norm.py:bwd_plan. partial:
// chunks * 2 * c floats. out: 2 * c floats, [sum dy | sum dy * x_hat].
// One cooperative launch on `stream`; returns a cudaError_t.
extern "C" int bn_bwd_reduce_launch(const void* x, const void* dy,
                                    const void* mean, const void* inv,
                                    int is_bf16, long long m, int c, int vec,
                                    int tile_c, int tiles, int stage_rows,
                                    int stages, int stage_pitch,
                                    long long rows_per_chunk, int chunks,
                                    int combine_cols, int grid, int smem,
                                    void* partial, void* out, void* stream) {
  bn_reduce::Plan p{m, c, tile_c, tiles, stage_rows, stages, stage_pitch,
                    rows_per_chunk, chunks, combine_cols};
  const void* kernel = kernel_for(is_bf16, vec);
  if (kernel == nullptr ||
      !bn_reduce::check_plan(p, 2, vec, is_bf16 ? 2 : 4, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  bn_reduce::Inputs<2> in = {};
  in.ptr[0] = x;
  in.ptr[1] = dy;
  cudaError_t e = bn_reduce::prepare(kernel, &in, is_bf16, vec, p, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&in, const_cast<void**>(&mean), const_cast<void**>(&inv),
                  &p, &partial, &out};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
