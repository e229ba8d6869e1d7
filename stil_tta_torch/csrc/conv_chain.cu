// The bottleneck's forward chain in one pass: BN-apply + ReLU of the
// previous layer's raw output, the 1x1 conv as an (M, K) x (K, N) product,
// the bfloat16 store of y and the next BN's column sums sum(y), sum(y^2).
//
// Replaces the Pallas TPU kernels tools/bench_conv_probe.py:
// pallas_chain_call (_chain_kernel, sums over the bfloat16 y) and
// pallas_chain_scratch_call (_chain_scratch_kernel, sums over the float32 y
// before rounding). One template serves both (STATS_FROM_F32); each has its
// own launcher. The TPU kernels carry the sums across a sequential grid;
// here each persistent block keeps its own (conv_chain_common.cuh) and a
// second pass adds the blocks' rows in a fixed order.
//
// Bound: device-memory bandwidth. At the probe's shape (M = 524,288,
// K = 256, N = 64) the kernel must read raw (268.4 MB) and write y
// (67.1 MB): 0.1002 ms at 3.35 TB/s, against 17.18 GFLOP, 0.0174 ms at
// the H100's 989 TFLOP/s bf16.
//
// Design (conv_chain_common.cuh has the shared machinery): one block an
// SM; its producer warp keeps up to four 64-row tiles of raw in flight
// with TMA, so device memory streams while the consumers compute; two
// consumer warpgroups take the block's tiles in turn. A stage holds the
// tile's K / 64 boxes of raw and N / 64 boxes for its y. The consumer
// applies the prologue h = max(bf16(bf16(raw * bf16(A)) + bf16(B)), 0)
// in place, 16 bytes a thread (packed bf16 multiply and add round once
// each, as the Pallas body's bf16 arithmetic does: the _rn forms keep the
// compiler from contracting them into one fma), and multiplies h by
// the resident weight with wgmma from shared memory (the SS form: h is
// written back to the swizzled stage rather than fed from registers, so
// every K fits one code path and the product shares its mainloop with
// the join). The epilogue rounds the accumulator to bfloat16, writes y
// into the stage's y boxes and takes the sums from registers (rows past M
// are masked: TMA loads them as zero raw, but h = max(bf16(B), 0) of a
// zero row is not zero); one TMA store per 64 columns writes y, clipped
// at M, and the stage goes back to the producer once the store has read
// it. Against the first version (wmma, one phase after another, two
// blocks an SM and 128 bytes a thread in flight, 15% of the bound), the
// loads now run ahead of and beside the products and the epilogue.

#include "conv_chain_common.cuh"

namespace {

using namespace conv_chain_common;

// v: eight bf16 of raw; a, b: the bf16 A and B of their columns.
__device__ __forceinline__ void prologue(uint4& v, const uint4& a,
                                         const uint4& b) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162* av = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __hmax2(__hadd2_rn(__hmul2_rn(x[i], av[i]), bv[i]), zero);
}

bool chain_plan(int k, int n, Plan* p) {
  const int kb = (k + kBox - 1) / kBox, nb = (n + kBox - 1) / kBox;
  if (nb > kMaxChunks) return false;
  return make_plan(kb + nb, kb * nb, 2 * kb * kBox * sizeof(bf16), p);
}

template <bool STATS_FROM_F32>
__global__ void __launch_bounds__(kThreads, 1)
conv_chain_kernel(const __grid_constant__ CUtensorMap raw_map,
                  const __grid_constant__ CUtensorMap y_map,
                  const bf16* __restrict__ w, const float* __restrict__ a_in,
                  const float* __restrict__ b_in, int64_t m, int k, int n,
                  int stages, float* __restrict__ partial) {
  // layout: stages (kb boxes of raw / h, nb of y) | w^T (kb boxes of
  // nb * 64 rows) | bf16(A) | bf16(B) | full and empty barriers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kb = (k + kBox - 1) / kBox, nb = (n + kBox - 1) / kBox;
  const int stage_bytes = (kb + nb) * kBoxBytes;
  uint8_t* sw = ring + stages * stage_bytes;
  bf16* sa = reinterpret_cast<bf16*>(sw + kb * nb * kBoxBytes);
  bf16* sb = sa + kb * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kb * kBox);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fill_weight(sw, w, k, n, kb, nb, false, tid, kThreads);
  for (int i = tid; i < kb * kBox; i += kThreads) {
    sa[i] = __float2bfloat16_rn(i < k ? a_in[i] : 0.f);
    sb[i] = __float2bfloat16_rn(i < k ? b_in[i] : 0.f);
  }
  fence_async_smem();
  __syncthreads();

  const int64_t tiles = (m + kRows - 1) / kRows;
  if (warp == kConsumers * 4) {  // the producer warp
    if (lane == 0) {
      int i = 0;
      for (int64_t tile = blockIdx.x; tile < tiles;
           tile += gridDim.x, ++i) {
        const int s = i % stages;
        mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kb * kBoxBytes);
        load_boxes(&raw_map, kb, ring + s * stage_bytes,
                   static_cast<int>(tile * kRows), &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4, t = tid % 128, w4 = warp % 4;
  float run[kMaxChunks][2][2] = {};
  int i = wg;
  for (int64_t tile = blockIdx.x + wg * gridDim.x; tile < tiles;
       tile += kConsumers * gridDim.x, i += kConsumers) {
    const int s = i % stages;
    uint8_t* st = ring + s * stage_bytes;
    mbar_wait(&full[s], (i / stages) & 1);

    for (int q = t; q < kb * 512; q += 128) {  // 16 bytes each, in place
      const int box = q >> 9, r = (q >> 3) & 63, pc = q & 7;
      const int col = box * kBox + ((pc ^ r) & 7) * 8;
      uint4* p = reinterpret_cast<uint4*>(st + box * kBoxBytes + r * 128 +
                                          pc * 16);
      uint4 v = *p;
      prologue(v, *reinterpret_cast<const uint4*>(sa + col),
               *reinterpret_cast<const uint4*>(sb + col));
      *p = v;
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);

    const int64_t row0 = tile * kRows;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nb) {  // not `break`: run[c] must stay in registers
        float d[32];
        product(d, st, sw, nb * kBoxBytes, c, kb);
        uint8_t* yb = st + (kb + c) * kBoxBytes;
        // column group j: y of both rows stored, their sums in v[sum][col]
        auto group = [&](int j, float (&v)[2][2]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i0 = 4 * j + 2 * h;
            const int r = 16 * w4 + 8 * h + (lane >> 2);
            const __nv_bfloat162 y2 = __floats2bfloat162_rn(d[i0], d[i0 + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                yb + swz(r, 8 * j + 2 * (lane & 3))) = y2;
            float2 y = STATS_FROM_F32 ? make_float2(d[i0], d[i0 + 1])
                                      : __bfloat1622float2(y2);
            if (row0 + r >= m) y = make_float2(0.f, 0.f);
            if (h == 0) {
              v[0][0] = y.x;
              v[0][1] = y.y;
              v[1][0] = y.x * y.x;
              v[1][1] = y.y * y.y;
            } else {
              v[0][0] += y.x;
              v[0][1] += y.y;
              v[1][0] = fmaf(y.x, y.x, v[1][0]);
              v[1][1] = fmaf(y.y, y.y, v[1][1]);
            }
          }
        };
        float u[2][2][4];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          float lo[2][2], hi[2][2];
          group(k4, lo);
          group(k4 + 4, hi);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            u[e / 2][e % 2][k4] = rs_first(lo[e / 2][e % 2], hi[e / 2][e % 2],
                                           lane);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          run[c][e / 2][e % 2] += rs_rest(u[e / 2][e % 2], lane);
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if (t == 0) {
      for (int c = 0; c < nb; ++c)
        tma_store(&y_map, st + (kb + c) * kBoxBytes, c * kBox,
                  static_cast<int>(row0));
      tma_store_drain();
      mbar_arrive(&empty[s]);
    }
  }
  write_partial_row<2>(run, nb, n, reinterpret_cast<float*>(ring), partial);
}

template <bool STATS_FROM_F32>
int launch(const void* raw, const void* w, const void* a, const void* b,
           long long m, int k, int n, void* y, void* partial, int max_blocks,
           void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan plan;
  if (!chain_plan(k, n, &plan)) return cudaErrorInvalidValue;
  CUtensorMap raw_map, y_map;
  cudaError_t e = tensor_map(&raw_map, raw, m, k);
  if (e == cudaSuccess) e = tensor_map(&y_map, y, m, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = conv_chain_kernel<STATS_FROM_F32>;
  int grid = 0;
  e = persistent_grid(kernel, plan.smem, m, max_blocks, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, plan.smem, st>>>(
      raw_map, y_map, static_cast<const bf16*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b), m, k, n,
      plan.stages, static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(column_sums(static_cast<const float*>(partial),
                                      grid, 2 * n, static_cast<float*>(out),
                                      st));
}

}  // namespace

// raw: (m, k) bf16, w: (k, n) bf16, a, b: k floats, all 16-byte aligned;
// k, n multiples of 16, n <= 256, the plan within 227 KB of shared memory
// (ops/conv_chain.py:_plan). y: (m, n) bf16. partial: max_blocks * 2n
// floats. out: 2n floats, [sum y | sum y^2]. Returns a CUDA error code, 0
// when both passes were launched.
extern "C" int conv_chain_launch(const void* raw, const void* w,
                                 const void* a, const void* b, long long m,
                                 int k, int n, void* y, void* partial,
                                 int max_blocks, void* out, void* stream) {
  return launch<false>(raw, w, a, b, m, k, n, y, partial, max_blocks, out,
                       stream);
}

// As conv_chain_launch, with the sums over the float32 y before rounding.
extern "C" int conv_chain_scratch_launch(const void* raw, const void* w,
                                         const void* a, const void* b,
                                         long long m, int k, int n, void* y,
                                         void* partial, int max_blocks,
                                         void* out, void* stream) {
  return launch<true>(raw, w, a, b, m, k, n, y, partial, max_blocks, out,
                      stream);
}
