// Per-channel BatchNorm statistics: sum(x) and sum(x*x) over the rows of a
// row-major (M, C) activation, accumulated in float32, in one launch.
//
// Replaces the Pallas TPU kernel stil_tta_tpu/ops/batch_norm.py:bn_stats
// (_stats_kernel). That kernel walks a sequential grid of row tiles and
// carries the two sums in its output block from step to step. Blocks on
// the GPU run in no order, so here every block sums its own share and a
// fixed-order combine inside the same kernel adds the shares up.
//
// Bound: device-memory bandwidth. The kernel reads M*C*2 bytes in bf16
// (M*C*4 in f32) and writes 2*C floats; its 3 flops an element are far
// below what the card computes per byte read, so tensor cores do not help.
// What the design does about each cost of the earlier two-pass kernel:
//
// 1. One launch a call. The grid is launched cooperatively
//    (cudaLaunchCooperativeKernel): every block writes its partial row,
//    then grid.sync(), then all blocks add the partial rows column by
//    column, each column in a fixed order (below). No float atomics and
//    no counter that outlives the call, so two launches on the same input
//    are bitwise equal and two streams may run the kernel at once.
// 2. A persistent grid with partials sized to it. The wrapper
//    (stil_tta_torch/ops/batch_norm.py:stats_plan) gives the grid: the SM
//    count times the blocks an SM holds (bn_stats_occupancy, at most two),
//    capped at the work. The work is cut into column tiles of at most 256
//    channels times row chunks of a contiguous, statically assigned row
//    range; block b takes the items b, b + grid, ... (one each at every
//    ResNet-50 shape). The partial buffer has one row of 2*C floats per
//    row chunk: at most about 256 KB at 1 block an SM.
// 3. Asynchronous copies into a shared-memory ring (16-byte-aligned input
//    with C a multiple of 16 bytes). Each stage is up to 32 KB (at most
//    256 rows) of a row chunk, brought in by the Tensor Memory Accelerator
//    and counted in bytes on one mbarrier per stage: one 1-D bulk copy
//    (cp.async.bulk) of the whole contiguous span when a tile is all of C;
//    else one 2-D box (cp.async.bulk.tensor, a tensor map of (M, C) with a
//    box of stage_rows x tile_c; rows and columns past the tensor load as
//    zeros), because one 1-D copy per 512-byte row ran at about half the
//    rate. The ring holds four stages. Threads lie along the
//    tile's channels, 16 bytes each, so a warp reads 512 consecutive bytes
//    of the stage (no bank conflicts) and keeps float32 sums of its rows
//    in registers. A __syncthreads after each stage frees its slot for
//    the next copy. The variant for unaligned input or odd C (vec = 1)
//    reads x directly with the same grid, row ranges and combine.
// 4. The launch plan is Python (stats_plan), tested on the CPU; this file
//    checks it (check_plan) and refuses a plan it cannot run.
//
// The ring walk, the partial rows and the combine are the one-input
// instance of bn_reduce_ring.cuh, which bn_bwd_reduce.cu instantiates
// with two inputs.
//
// The order of every sum is fixed by the shape and the plan: a thread
// adds its rows in row order; a block adds its row lanes in order; in the
// combine, threads add interleaved row chunks in order, then meet in a
// fixed shuffle tree and in warp order.

#include "bn_reduce_ring.cuh"

namespace {

using bn_reduce::kThreads;
using bn_reduce::Load;

// One input: s += x, q += x * x.
template <typename T, int VEC>
struct StatsOp {
  using Elem = T;
  static constexpr int kVec = VEC, kInputs = 1, kFlight = 4;
  using Raw = typename Load<T, VEC>::Raw;

  __device__ __forceinline__ void begin(int, bool) {}

  __device__ __forceinline__ void add(const Raw (&v)[1], float (&s)[VEC],
                                      float (&q)[VEC]) const {
    float f[VEC];
    Load<T, VEC>::unpack(v[0], f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] += f[i];
      q[i] = fmaf(f[i], f[i], q[i]);
    }
  }
};

// VEC = 16 / sizeof(T): ring path; VEC = 1: direct loads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const __grid_constant__ bn_reduce::Inputs<1> in,
                const bn_reduce::Plan p, float* __restrict__ partial,
                float* __restrict__ out) {
  bn_reduce::reduce(in, StatsOp<T, VEC>{}, p, partial, out);
}

template <typename T, int VEC>
const void* entry() {
  return reinterpret_cast<const void*>(bn_stats_kernel<T, VEC>);
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
extern "C" int bn_stats_occupancy(int is_bf16, int vec, int smem, int* sms,
                                  int* blocks_per_sm) {
  const void* kernel = kernel_for(is_bf16, vec);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bn_reduce::occupancy(kernel, smem, sms, blocks_per_sm));
}

// x: (m, c) row-major, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
// vec: 16 / itemsize (x 16-byte aligned, c % vec == 0), else 1. The plan
// (tile_c .. combine_cols, grid, smem) is ops/batch_norm.py:stats_plan.
// partial: chunks * 2 * c floats. out: 2 * c floats, [sum | sum of
// squares]. One cooperative launch on `stream`; returns a cudaError_t.
extern "C" int bn_stats_launch(const void* x, int is_bf16, long long m,
                               int c, int vec, int tile_c, int tiles,
                               int stage_rows, int stages, int stage_pitch,
                               long long rows_per_chunk, int chunks,
                               int combine_cols, int grid, int smem,
                               void* partial, void* out, void* stream) {
  bn_reduce::Plan p{m, c, tile_c, tiles, stage_rows, stages, stage_pitch,
                    rows_per_chunk, chunks, combine_cols};
  const void* kernel = kernel_for(is_bf16, vec);
  if (kernel == nullptr ||
      !bn_reduce::check_plan(p, 1, vec, is_bf16 ? 2 : 4, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  bn_reduce::Inputs<1> in = {};
  in.ptr[0] = x;
  cudaError_t e = bn_reduce::prepare(kernel, &in, is_bf16, vec, p, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&in, &p, &partial, &out};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
