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
// The order of every sum is fixed by the shape and the plan: a thread
// adds its rows in row order; a block adds its row lanes in order; in the
// combine, threads add interleaved row chunks in order, then meet in a
// fixed shuffle tree and in warp order.

#include <cooperative_groups.h>

#include "bn_reduce_common.cuh"
#include "conv_chain_common.cuh"  // the mbarrier and TMA helpers

namespace {

namespace cg = cooperative_groups;
using bn_reduce::kThreads;
using bn_reduce::Load;
using conv_chain_common::mbar_expect_tx;
using conv_chain_common::mbar_init;
using conv_chain_common::mbar_wait;
using conv_chain_common::smem_u32;

constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;  // the mbarriers; the ring follows
constexpr int kSmemFixed = 256;     // the barriers and 128 bytes to align
constexpr int kMaxTile = 256;       // channels of a column tile
constexpr int kMaxStageRows = 256;  // a box's rows

// Mirrors ops/batch_norm.py:StatsPlan.
struct Plan {
  int64_t m;
  int c;
  int tile_c;          // channels of a column tile (a multiple of vec)
  int tiles;
  int stage_rows;      // rows of a ring stage (vec > 1)
  int stages;          // ring depth (vec > 1)
  int stage_pitch;     // bytes from one stage to the next
  int64_t rows_per_chunk;
  int chunks;          // row chunks = rows of the partial buffer
  int combine_cols;    // output columns a block adds at once
};

// An L2 policy that evicts these lines first: x is read once, so its
// lines replace each other and not what else the cache holds.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "l"(policy)
      : "memory");
}

// The box at (column x, row y) of the tensor of `map` into dst.
__device__ __forceinline__ void box_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

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

// Rows r = first, first + step, ... < end of the units at base + r * pitch
// (bytes), four loads in flight, added in row order.
template <typename T, int VEC>
__device__ __forceinline__ void sum_rows(const uint8_t* base, int64_t pitch,
                                         int64_t first, int64_t end,
                                         int step, float (&s)[VEC],
                                         float (&q)[VEC]) {
  using Raw = typename Load<T, VEC>::Raw;
  auto at = [&](int64_t r) {
    return *reinterpret_cast<const Raw*>(base + r * pitch);
  };
  int64_t r = first;
  for (; r + 3 * step < end; r += 4 * step) {
    const Raw v0 = at(r), v1 = at(r + step), v2 = at(r + 2 * step),
              v3 = at(r + 3 * step);
    accumulate<T, VEC>(v0, s, q);
    accumulate<T, VEC>(v1, s, q);
    accumulate<T, VEC>(v2, s, q);
    accumulate<T, VEC>(v3, s, q);
  }
  for (; r < end; r += step) accumulate<T, VEC>(at(r), s, q);
}

// One item (rows r0..r1 of the tile at column col0, `width` channels wide)
// through the ring. seq counts the block's stages so far: stage k sits in
// slot k % stages and completes phase (k / stages) & 1 of its barrier.
// Returns the new count.
template <typename T, int VEC>
__device__ __forceinline__ uint32_t ring_pass(
    const T* __restrict__ x, const CUtensorMap* map, const Plan& p,
    uint64_t* full, uint8_t* ring, int col0, int width, int64_t r0,
    int64_t r1, uint32_t seq, bool active, int tx, int ty, int rows_per_step,
    float (&s)[VEC], float (&q)[VEC]) {
  const int tid = threadIdx.x;
  const uint64_t policy = evict_first();
  const int64_t n = (r1 - r0 + p.stage_rows - 1) / p.stage_rows;
  const int row_pitch = p.tile_c * static_cast<int>(sizeof(T));
  const uint32_t row_bytes = width * static_cast<uint32_t>(sizeof(T));

  auto rows_of = [&](int64_t j) {
    const int64_t left = r1 - r0 - j * p.stage_rows;
    return static_cast<int>(left < p.stage_rows ? left : p.stage_rows);
  };
  // thread 0 only
  auto load_stage = [&](int64_t j) {
    const uint32_t slot = (seq + static_cast<uint32_t>(j)) % p.stages;
    uint8_t* dst = ring + slot * p.stage_pitch;
    const int64_t r = r0 + j * p.stage_rows;
    if (p.tiles == 1) {  // the tile is the whole row: one contiguous span
      const uint32_t bytes = rows_of(j) * row_bytes;
      mbar_expect_tx(&full[slot], bytes);
      bulk_load(dst, x + r * p.c, bytes, &full[slot], policy);
    } else {  // a whole box, zeros past the tensor's rows and columns
      mbar_expect_tx(&full[slot], p.stage_rows * row_pitch);
      box_load(dst, map, col0, static_cast<int>(r), &full[slot], policy);
    }
  };

  if (tid == 0) {
    for (int64_t j = 0; j < n && j < p.stages; ++j) load_stage(j);
  }
  for (int64_t j = 0; j < n; ++j) {
    const uint32_t k = seq + static_cast<uint32_t>(j);
    const uint32_t slot = k % p.stages;
    mbar_wait(&full[slot], (k / p.stages) & 1);
    if (active)
      sum_rows<T, VEC>(ring + slot * p.stage_pitch + tx * 16, row_pitch, ty,
                       rows_of(j), rows_per_step, s, q);
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && j + p.stages < n) load_stage(j + p.stages);
  }
  return seq + static_cast<uint32_t>(n);
}

// Adds the block's row lanes in order and writes the item's partial row:
// partial[chunk] = [sums | squares], each C wide, at the tile's columns.
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

// VEC = 16 / sizeof(T): ring path; VEC = 1: direct loads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x,
                const __grid_constant__ CUtensorMap map, const Plan p,
                float* __restrict__ partial, float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + kBarrierBytes;
  float* scratch = reinterpret_cast<float*>(ring);
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) __trap();  // not launched cooperatively

  const int tid = threadIdx.x;
  const int units = p.tile_c / VEC;  // threads across a tile's row
  const int rows_per_step = kThreads / units;
  const int tx = tid % units, ty = tid / units;

  if (VEC > 1) {
    if (tid == 0) {
      for (int i = 0; i < p.stages; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  uint32_t seq = 0;
  const int items = p.tiles * p.chunks;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % p.tiles, chunk = item / p.tiles;
    const int col0 = tile * p.tile_c;
    const int width = min(p.tile_c, p.c - col0);
    const int64_t r0 = static_cast<int64_t>(chunk) * p.rows_per_chunk;
    const int64_t r1 =
        r0 + p.rows_per_chunk < p.m ? r0 + p.rows_per_chunk : p.m;
    const bool active = ty < rows_per_step && tx * VEC < width;
    float s[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = 0.f;
      q[i] = 0.f;
    }
    if constexpr (VEC > 1) {
      seq = ring_pass<T, VEC>(x, &map, p, full, ring, col0, width, r0, r1,
                              seq, active, tx, ty, rows_per_step, s, q);
    } else {
      if (active)
        sum_rows<T, 1>(reinterpret_cast<const uint8_t*>(x + col0 + tx),
                       static_cast<int64_t>(p.c) * sizeof(T), r0 + ty, r1,
                       rows_per_step, s, q);
    }
    write_partial<VEC>(s, q, active, tx, ty, rows_per_step, p, col0, width,
                       chunk, scratch, partial);
  }

  grid.sync();  // every partial row is written and visible
  combine(p, partial, out, scratch);
}

// The plan's arithmetic, as stats_plan computes it; a plan this kernel
// cannot run is refused before launch.
bool check_plan(const Plan& p, int vec, int itemsize, int grid, int smem) {
  const int64_t ring = static_cast<int64_t>(p.stages) * p.stage_pitch;
  const int64_t scratch = 2LL * kThreads * vec * 4;
  const bool tiles_ok = p.tile_c > 0 && p.tile_c <= kMaxTile &&
                        p.tile_c % vec == 0 && p.tile_c / vec <= kThreads &&
                        static_cast<int64_t>(p.tiles) * p.tile_c >= p.c &&
                        static_cast<int64_t>(p.tiles - 1) * p.tile_c < p.c;
  const bool rows_ok = p.m > 0 && p.rows_per_chunk > 0 && p.chunks > 0 &&
                       p.rows_per_chunk * p.chunks >= p.m &&
                       p.rows_per_chunk * (p.chunks - 1) < p.m;
  const bool ring_ok =
      vec == 1 ||
      (p.stages >= 1 && p.stages <= kMaxStages && p.stage_rows >= 1 &&
       p.stage_rows <= kMaxStageRows &&
       p.stage_pitch % 128 == 0 &&
       static_cast<int64_t>(p.stage_rows) * p.tile_c * itemsize <=
           p.stage_pitch &&
       static_cast<int64_t>(p.c) * itemsize % 16 == 0);
  const bool combine_ok = p.combine_cols >= 1 &&
                          p.combine_cols <= kThreads &&
                          kThreads % p.combine_cols == 0 &&
                          (p.combine_cols & (p.combine_cols - 1)) == 0;
  return tiles_ok && rows_ok && ring_ok && combine_ok && grid >= 1 &&
         smem >= kSmemFixed + (vec > 1 ? ring : 0) &&
         smem >= kSmemFixed + scratch;
}

template <typename T, int VEC>
const void* entry() {
  return reinterpret_cast<const void*>(bn_stats_kernel<T, VEC>);
}

// The map of x as a (m, c) tensor in boxes of stage_rows x tile_c,
// unswizzled; elements past its rows or columns load as zeros.
cudaError_t stats_map(CUtensorMap* map, const void* x, int is_bf16,
                      const Plan& p) {
  conv_chain_common::EncodeTiled encode = conv_chain_common::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.c),
                              static_cast<cuuint64_t>(p.m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.c) *
                                 (is_bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(p.tile_c),
                             static_cast<cuuint32_t>(p.stage_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
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
  Plan p{m, c, tile_c, tiles, stage_rows, stages, stage_pitch,
         rows_per_chunk, chunks, combine_cols};
  const void* kernel = kernel_for(is_bf16, vec);
  if (kernel == nullptr || !check_plan(p, vec, is_bf16 ? 2 : 4, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map = {};  // read only by the ring path over several tiles
  cudaError_t e = cudaSuccess;
  if (vec > 1 && tiles > 1) e = stats_map(&map, x, is_bf16, p);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {const_cast<void**>(&x), &map, &p, &partial, &out};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
