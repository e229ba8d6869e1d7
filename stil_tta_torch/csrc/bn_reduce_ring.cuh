// The one-launch column reduction that bn_stats.cu (one input) and
// bn_bwd_reduce.cu (two inputs, x and dy) instantiate: for row-major
// (M, C) inputs of one shape and type, two float32 sums a channel, in one
// cooperative launch. An Op gives what is summed (header note of each
// kernel); this file gives how the rows reach the threads and how the
// blocks' sums meet. It needs the mbarrier and TMA helpers of
// conv_chain_common.cuh, which itself includes bn_reduce_common.cuh, so
// it is a header of its own.
//
// The grid is persistent (the wrapper's plan: the SM count times the
// blocks an SM holds, at most two, capped at the work). The work is cut
// into column tiles of at most 256 channels x row chunks of a contiguous,
// statically assigned row range; block b takes the items b, b + grid, ...
// and writes one partial row of 2*C floats an item (write_partial), then
// grid.sync(), then every block adds partial rows column by column in a
// fixed order (combine). No float atomics and no counter that outlives
// the call: two launches on the same input are bitwise equal.
//
// Rows reach the threads through a ring of shared-memory stages (vec > 1:
// a 16-byte-aligned base and C a multiple of 16 bytes). A stage holds the
// same stage_rows rows of every input, each input's part 128-byte aligned
// inside it, brought in by the Tensor Memory Accelerator and counted in
// bytes on the stage's one mbarrier: one 1-D bulk copy (cp.async.bulk) an
// input of the contiguous span when a tile is all of C; else one 2-D box
// (cp.async.bulk.tensor, a tensor map of (M, C) with a box of stage_rows x
// tile_c) an input. Threads lie along the tile's channels, 16 bytes of
// each input a thread, so a warp reads 512 consecutive bytes of a part (no
// bank conflicts); kFlight rows are loaded before they are added, in row
// order, to float32 sums in registers. A __syncthreads after each stage
// frees its slot for the next copy. The direct variant (vec = 1) reads the
// inputs from device memory with the same grid, row chunks and combine.
//
// Op interface: Elem (the element type), kVec, kInputs, kFlight;
// begin(ch, active) before an item (ch: the thread's first channel);
// add(v, s, q) for one row, v[i] the Raw unit of input i.

#pragma once

#include <cooperative_groups.h>

#include "bn_reduce_common.cuh"
#include "conv_chain_common.cuh"  // the mbarrier and TMA helpers

namespace bn_reduce {

namespace cg = cooperative_groups;
using conv_chain_common::mbar_expect_tx;
using conv_chain_common::mbar_init;
using conv_chain_common::mbar_wait;
using conv_chain_common::smem_u32;

constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;  // the mbarriers; the ring follows
constexpr int kSmemFixed = 256;     // the barriers and 128 bytes to align
constexpr int kMaxTile = 256;       // channels of a column tile
constexpr int kMaxStageRows = 256;  // a box's rows

// The kernel's inputs: base pointers and, for the ring over several
// column tiles, their tensor maps (read by TMA from the parameter space).
template <int N>
struct Inputs {
  CUtensorMap map[N];
  const void* ptr[N];
};

// An L2 policy that evicts these lines first: the inputs are read once,
// so their lines replace each other and not what else the cache holds.
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

// Rows r = first, first + step, ... < end of the units at base[i] + r *
// pitch (bytes) of each input i, kFlight rows in flight, added in row
// order.
template <class Op>
__device__ __forceinline__ void sum_rows(
    const uint8_t* const (&base)[Op::kInputs], int64_t pitch, int64_t first,
    int64_t end, int step, const Op& op, float (&s)[Op::kVec],
    float (&q)[Op::kVec]) {
  using Raw = typename Load<typename Op::Elem, Op::kVec>::Raw;
  constexpr int N = Op::kInputs, F = Op::kFlight;
  auto at = [&](int i, int64_t r) {
    return *reinterpret_cast<const Raw*>(base[i] + r * pitch);
  };
  int64_t r = first;
  for (; r + (F - 1) * step < end; r += F * step) {
    Raw v[F][N];
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[f][i] = at(i, r + f * step);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) op.add(v[f], s, q);
  }
  for (; r < end; r += step) {
    Raw v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = at(i, r);
    op.add(v, s, q);
  }
}

// One item (rows r0..r1 of the tile at column col0, `width` channels wide)
// through the ring. seq counts the block's stages so far: stage k sits in
// slot k % stages and completes phase (k / stages) & 1 of its barrier.
// Returns the new count.
template <class Op>
__device__ __forceinline__ uint32_t ring_pass(
    const Inputs<Op::kInputs>& in, const Op& op, const Plan& p,
    uint64_t* full, uint8_t* ring, int col0, int width, int64_t r0,
    int64_t r1, uint32_t seq, bool active, int tx, int ty, int rows_per_step,
    float (&s)[Op::kVec], float (&q)[Op::kVec]) {
  using T = typename Op::Elem;
  constexpr int N = Op::kInputs;
  const int tid = threadIdx.x;
  const uint64_t policy = evict_first();
  const int64_t n = (r1 - r0 + p.stage_rows - 1) / p.stage_rows;
  const int row_pitch = p.tile_c * static_cast<int>(sizeof(T));
  const uint32_t row_bytes = width * static_cast<uint32_t>(sizeof(T));
  const int part = p.stage_pitch / N;  // one input's share of a stage

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
      mbar_expect_tx(&full[slot], N * bytes);
#pragma unroll
      for (int i = 0; i < N; ++i)
        bulk_load(dst + i * part, static_cast<const T*>(in.ptr[i]) + r * p.c,
                  bytes, &full[slot], policy);
    } else {  // a whole box, zeros past the tensor's rows and columns
      mbar_expect_tx(&full[slot], N * p.stage_rows * row_pitch);
#pragma unroll
      for (int i = 0; i < N; ++i)
        box_load(dst + i * part, &in.map[i], col0, static_cast<int>(r),
                 &full[slot], policy);
    }
  };

  if (tid == 0) {
    for (int64_t j = 0; j < n && j < p.stages; ++j) load_stage(j);
  }
  for (int64_t j = 0; j < n; ++j) {
    const uint32_t k = seq + static_cast<uint32_t>(j);
    const uint32_t slot = k % p.stages;
    mbar_wait(&full[slot], (k / p.stages) & 1);
    if (active) {
      const uint8_t* base[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        base[i] = ring + slot * p.stage_pitch + i * part + tx * 16;
      sum_rows<Op>(base, row_pitch, ty, rows_of(j), rows_per_step, op, s, q);
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && j + p.stages < n) load_stage(j + p.stages);
  }
  return seq + static_cast<uint32_t>(n);
}

// The kernel's body: every item through the ring (or direct loads), one
// partial row an item, grid.sync(), the combine. out: 2*C floats.
template <class Op>
__device__ __forceinline__ void reduce(const Inputs<Op::kInputs>& in,
                                       Op op, const Plan& p,
                                       float* __restrict__ partial,
                                       float* __restrict__ out) {
  using T = typename Op::Elem;
  constexpr int N = Op::kInputs, VEC = Op::kVec;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // 128-byte aligned by pointer arithmetic on the shared array, not
  // through an integer: the compiler then knows every pointer below is
  // shared and reads the ring with shared loads (LDS), not generic ones
  uint8_t* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
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
    op.begin(col0 + tx * VEC, active);
    float s[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = 0.f;
      q[i] = 0.f;
    }
    if constexpr (VEC > 1) {
      seq = ring_pass<Op>(in, op, p, full, ring, col0, width, r0, r1, seq,
                          active, tx, ty, rows_per_step, s, q);
    } else if (active) {
      const uint8_t* base[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        base[i] = static_cast<const uint8_t*>(in.ptr[i]) +
                  static_cast<int64_t>(col0 + tx) * sizeof(T);
      sum_rows<Op>(base, static_cast<int64_t>(p.c) * sizeof(T), r0 + ty, r1,
                   rows_per_step, op, s, q);
    }
    write_partial<VEC>(s, q, active, tx, ty, rows_per_step, p, col0, width,
                       chunk, scratch, partial);
  }

  grid.sync();  // every partial row is written and visible
  combine(p, partial, out, scratch);
}

// The plan's arithmetic, as the wrapper computes it for `inputs` inputs;
// a plan the kernel cannot run is refused before launch.
inline bool check_plan(const Plan& p, int inputs, int vec, int itemsize,
                       int grid, int smem) {
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
       p.stage_pitch % (128 * inputs) == 0 &&
       static_cast<int64_t>(p.stage_rows) * p.tile_c * itemsize <=
           p.stage_pitch / inputs &&
       static_cast<int64_t>(p.c) * itemsize % 16 == 0);
  const bool combine_ok = p.combine_cols >= 1 &&
                          p.combine_cols <= kThreads &&
                          kThreads % p.combine_cols == 0 &&
                          (p.combine_cols & (p.combine_cols - 1)) == 0;
  return tiles_ok && rows_ok && ring_ok && combine_ok && grid >= 1 &&
         smem >= kSmemFixed + (vec > 1 ? ring : 0) &&
         smem >= kSmemFixed + scratch;
}

// The map of an input as a (m, c) tensor in boxes of stage_rows x tile_c,
// unswizzled; elements past its rows or columns load as zeros.
inline cudaError_t input_map(CUtensorMap* map, const void* x, int is_bf16,
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

// Fills in's tensor maps (only the ring over several tiles reads them) and
// sets the kernel's shared memory; then the caller launches.
template <int N>
cudaError_t prepare(const void* kernel, Inputs<N>* in, int is_bf16,
                    int vec, const Plan& p, int smem) {
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < N && e == cudaSuccess; ++i)
    if (vec > 1 && p.tiles > 1) e = input_map(&in->map[i], in->ptr[i],
                                              is_bf16, p);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return e;
}

// The current device's SM count and how many blocks of `kernel` with
// `smem` bytes of dynamic shared memory an SM holds: the wrapper's grid is
// at most their product (a cooperative launch needs every block resident).
inline cudaError_t occupancy(const void* kernel, int smem, int* sms,
                             int* blocks_per_sm) {
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
  return e;
}

}  // namespace bn_reduce
