// Shared pieces of the fused 1x1-conv kernels (conv_chain.cu and
// conv_bwd_join.cu) for Hopper (sm_90a): TMA tensor maps and copies,
// mbarrier waits, the wgmma m64n64k16 product from shared memory, the
// weight's copy into the layout wgmma reads, the fixed-order column sums
// and the launch plan.
//
// Both kernels run one persistent block per SM. Tile t (64 rows) goes to
// block t % grid in a static order. A block has kConsumers consumer
// warpgroups, which take the block's tiles in turn, and one producer warp
// whose lane 0 keeps a ring of up to kMaxStages stages filled with TMA
// loads (cp.async.bulk.tensor) ahead of them, each stage with a full and
// an empty mbarrier. The roles split once, for the kernel's life. The
// producer is a single warp and not a warpgroup, so there is no
// setmaxnreg: at 288 threads every thread may use 168 registers, and the
// consumers need at most 168 (the chain) and 151 (the join), no spills.
//
// Layout: every matrix in shared memory is cut into boxes of 64 rows by
// 64 bfloat16 columns (8 KB, one 128-byte row each), stored with the
// 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B): the 16-byte chunk j of
// row r sits at chunk j ^ (r % 8). TMA writes the inputs so and reads the
// outputs so; the threads that read or write a box by hand apply the same
// XOR (swz below), which also keeps their accesses free of bank
// conflicts. A row wider than 64 is several boxes; a width that is not a
// multiple of 64 is padded with zeros (TMA fills the columns and rows past
// the tensor's end with zeros on load and clips them on store).
//
// The product: wgmma.mma_async m64n64k16, bf16 in, float32 accumulated in
// 32 registers a thread, A and B both from shared memory (the SS form),
// K-major and 128-byte swizzled: the descriptor of a box's 16-column step
// kk starts 32 * kk bytes into the box, with a stride of 1024 bytes
// between groups of 8 rows. The weight is copied once per block into
// that K-major layout (the chain's row-major (K, N) w is transposed on the
// way), N-wide outputs are taken in 64-column chunks.
//
// The column sums: thread (warp w, lane l) holds, for each 64-column
// chunk, rows 16 w + l / 4 and 16 w + 8 + l / 4 of columns 8 j + 2 (l % 4)
// and one more, j = 0..7. It adds its two rows, then a reduce-scatter over
// the eight lanes l / 4 (three shuffle steps, seven shuffles) leaves lane
// group g = l / 4 with the warp's total of column group g, which it adds
// to its running sums in registers. At the end the warps' sums go through
// shared memory and are added in warp order into one partial row per
// block; bn_reduce::column_sums_kernel adds the rows in a fixed order. No
// float atomics and a static schedule: two launches on the same input
// give bitwise-equal results.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_reduce_common.cuh"

namespace conv_chain_common {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                    // rows of a tile
constexpr int kBox = 64;                     // bf16 columns of a box
constexpr int kBoxBytes = kRows * kBox * 2;  // 8 KB
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kMaxChunks = 4;                // output width <= 256
constexpr size_t kSmemLimit = 232448;        // 227 KB a block on the H100

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the bf16 pair at (row r, column c, c even) in a box.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// ---------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A phase that never completes is a bug of this file: rather than hang
// the card, the wait traps after about 2^26 polls (seconds), which fails
// the launch with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

// Barrier `id` (1..15) over `count` threads: a consumer warpgroup, or all
// consumers; the producer warp never takes part.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma, TMA stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------- TMA

// One 64 x 64 box at (column x, row y) of a 2-D bf16 tensor into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(smem_u32(src))
      : "memory");
}

// Commits this thread's TMA stores and waits until they have read shared
// memory (the writes to device memory may still be in flight).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The producer's loads of one tile: `boxes` boxes of 64 columns of the
// tensor of `map` at rows row0.., into consecutive boxes from dst.
__device__ __forceinline__ void load_boxes(const CUtensorMap* map, int boxes,
                                           uint8_t* dst, int row0,
                                           uint64_t* bar) {
  for (int b = 0; b < boxes; ++b)
    tma_load(dst + b * kBoxBytes, map, b * kBox, row0, bar);
}

// ---------------------------------------------------------- wgmma

// Descriptor of a K-major, 128-byte-swizzled operand at p (a box, plus
// 32 bytes for each 16-column step): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (+)= A (64 x 16) * B (16 x 64); d is overwritten when !accumulate.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// d = the (64 x 64) chunk `chunk` of A * B over kb boxes of depth: A's
// box kk at a + kk * kBoxBytes, B's at b + kk * b_box_stride, each the
// chunk's 64 rows of B^T starting chunk * kBoxBytes into it.
__device__ __forceinline__ void product(float (&d)[32], const uint8_t* a,
                                        const uint8_t* b, int b_box_stride,
                                        int chunk, int kb) {
  __syncwarp();  // the barrier waits may leave the lanes apart
  wgmma_fence();
  for (int k = 0; k < 4 * kb; ++k) {
    const int box = k >> 2, step = (k & 3) * 32;
    wgmma_64x64x16(d, desc(a + box * kBoxBytes + step),
                   desc(b + box * b_box_stride + chunk * kBoxBytes + step),
                   k > 0);
  }
  wgmma_commit_wait();
}

// ---------------------------------------------------------- weight

// Copies a weight into the boxes of B^T (rows = the n_out outputs, K-major
// over k_in): box kk (k_in / 64 of them, padded) holds rows 0..n_pad - 1,
// 128 bytes each, so it starts kk * n_pad * 128 bytes in. Element (k, n)
// is src[n * k_in + k] when n_major_src (the join's (NJ, N) w1), else
// src[k * n_out + n] (the chain's (K, N) w); zero past k_in or n_out.
__device__ __forceinline__ void fill_weight(uint8_t* dst,
                                            const bf16* __restrict__ src,
                                            int k_in, int n_out, int kb,
                                            int nb, bool n_major_src,
                                            int tid, int threads) {
  const int k_pad = kb * kBox, n_pad = nb * kBox;
  for (int i = tid; i < k_pad * n_pad; i += threads) {
    int k, n;
    if (n_major_src) {
      n = i / k_pad;
      k = i % k_pad;
    } else {
      k = i / n_pad;
      n = i % n_pad;
    }
    bf16 v = __float2bfloat16_rn(0.f);
    if (k < k_in && n < n_out)
      v = n_major_src ? src[n * k_in + k] : src[k * n_out + n];
    const uint32_t at = (k / kBox) * n_pad * 128 + n * 128 +
                        ((((k % kBox) >> 3) ^ n) & 7) * 16 + (k & 7) * 2;
    *reinterpret_cast<bf16*>(dst + at) = v;
  }
}

// ---------------------------------------------------------- column sums

// A reduce-scatter of column groups j = 0..7 over the eight lane groups
// g = lane / 4 that leaves group g with the sum of column group g, in a
// fixed order, in two parts so that only half the values stay live:
// rs_first(v[k], v[k + 4]) takes the first step (shuffle over lane ^ 16)
// as soon as groups k and k + 4 are known, giving u[k] (group k + 4 b2);
// rs_rest(u) the two others (lane ^ 8, lane ^ 4).
__device__ __forceinline__ float rs_first(float lo, float hi, int lane) {
  const bool b2 = (lane >> 4) & 1;
  return (b2 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b2 ? lo : hi, 16);
}

__device__ __forceinline__ float rs_rest(const float (&u)[4], int lane) {
  const bool b1 = (lane >> 3) & 1, b0 = (lane >> 2) & 1;
  float w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    w[k] = (b1 ? u[k + 2] : u[k]) +
           __shfl_xor_sync(0xffffffffu, b1 ? u[k] : u[k + 2], 8);
  return (b0 ? w[1] : w[0]) +
         __shfl_xor_sync(0xffffffffu, b0 ? w[0] : w[1], 4);
}

// End of the block, consumer threads only: run[c][s][q] is this thread's
// running sum s of column 64 c + 8 (lane / 4) + 2 (lane % 4) + q. The
// warps' sums meet in `scratch` (8 * NS * nb * 64 floats) and
// partial[blockIdx.x * NS * n_out + s * n_out + col] is their sum in warp
// order.
template <int NS>
__device__ __forceinline__ void write_partial_row(
    const float (&run)[kMaxChunks][NS][2], int nb, int n_out, float* scratch,
    float* __restrict__ partial) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_pad = nb * kBox;
  bar_sync(3, kConsumerThreads);  // every tile done, the stages are free
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < nb) {  // not `break`: it keeps the loop from unrolling
      const int col = c * kBox + 8 * (lane >> 2) + 2 * (lane & 3);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float* row = scratch + (warp * NS + s) * n_pad;
        row[col] = run[c][s][0];
        row[col + 1] = run[c][s][1];
      }
    }
  }
  bar_sync(3, kConsumerThreads);
  for (int i = tid; i < NS * n_out; i += kConsumerThreads) {
    const int s = i / n_out, col = i % n_out;
    float t = 0.f;
    for (int w = 0; w < kConsumerThreads / 32; ++w)
      t += scratch[(w * NS + s) * n_pad + col];
    partial[static_cast<int64_t>(blockIdx.x) * NS * n_out + i] = t;
  }
}

// ---------------------------------------------------------- host side

// The shared-memory plan, as ops/conv_chain.py:_plan computes it: the
// stages, then the weight, then `extra` bytes, then the barriers, after
// up to 1 KB that aligns the start to 1024 bytes (the swizzle's period).
struct Plan {
  int stages;
  size_t stage_bytes, weight_bytes, extra_bytes, smem;
};

inline bool make_plan(int stage_boxes, int weight_boxes, size_t extra,
                      Plan* p) {
  p->stage_bytes = static_cast<size_t>(stage_boxes) * kBoxBytes;
  p->weight_bytes = static_cast<size_t>(weight_boxes) * kBoxBytes;
  p->extra_bytes = extra;
  const size_t fixed = 1024 + p->weight_bytes + extra + 2 * kMaxStages * 8;
  if (fixed + 2 * p->stage_bytes > kSmemLimit) return false;
  p->stages = static_cast<int>((kSmemLimit - fixed) / p->stage_bytes);
  if (p->stages > kMaxStages) p->stages = kMaxStages;
  p->smem = fixed + p->stages * p->stage_bytes;
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not
// link: the CUDA runtime hands out its address.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (rows, cols) bf16 tensor in 64 x 64 boxes,
// 128-byte swizzled; out-of-bounds elements load as zero.
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr,
                              int64_t rows, int cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBox, kRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The shared-memory attribute and the grid: one block an SM, at most one
// for each tile and at most max_blocks (the rows of the partial buffer).
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
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (m + kRows - 1) / kRows;
  int64_t g = sms;
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
