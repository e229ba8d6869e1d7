// The bottleneck's backward residual join in one pass: the 1x1 conv's
// input gradient dx = dy_up @ w1^T, the residual add, the ReLU mask of the
// block's input, and the three column sums its BatchNorm's backward needs.
//
// Replaces the Pallas TPU kernel tools/bench_conv_probe.py:
// pallas_bwd_join_call (_join_kernel). Per row, as the Pallas body:
//   dx = bf16(dy_up @ w1^T)          float32 accumulation
//   dy = bf16(dx + dy_res)
//   xc = f32(x_raw) - mu
//   dy = xc > 0 ? dy : 0             stored as bfloat16
// and, over the rows, sum(dy), sum(dy * xc), sum(dy^2) in float32 from
// the stored dy. The TPU kernel carries the sums across a sequential grid;
// here each persistent block keeps its own (conv_chain_common.cuh) and a
// second pass adds the blocks' rows in a fixed order.
//
// Bound: device-memory bandwidth. At the probe's shape (M = 524,288,
// N = 64, NJ = 256) the kernel must read dy_up (67.1 MB), dy_res and
// x_raw (268.4 MB each) and write dy (268.4 MB): 872.4 MB, 0.2604 ms at
// 3.35 TB/s, against 17.18 GFLOP, 0.0174 ms at 989 TFLOP/s bf16.
//
// Design (conv_chain_common.cuh has the shared machinery): one block an
// SM; its producer warp brings in, with TMA, each 64-row tile's dy_up
// (N / 64 boxes), dy_res and x_raw (NJ / 64 boxes each: 72 KB a stage at
// the probe's shape, so two stages fit beside the 32 KB weight), and two
// consumer warpgroups take the block's tiles in turn. For each 64-column
// chunk of NJ a consumer multiplies the dy_up tile by the resident w1
// (already K-major: (NJ, N) row-major) with wgmma from shared memory,
// then reads the chunk's dy_res and x_raw from the stage, forms dy, writes
// it over dy_res in place and takes the three sums from registers. One
// TMA store per chunk writes dy, and the stage goes back to the producer
// once the stores have read it. Against the first version, whose
// epilogue read dy_res and x_raw from device memory 4 bytes a lane with
// nothing in flight during the products (31% of the bound), every input
// now arrives by TMA ahead of its use and every output leaves by TMA.

#include "conv_chain_common.cuh"

namespace {

using namespace conv_chain_common;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

bool join_plan(int nj, int n, Plan* p) {
  const int kb = (n + kBox - 1) / kBox, nb = (nj + kBox - 1) / kBox;
  if (nb > kMaxChunks) return false;
  return make_plan(kb + 2 * nb, kb * nb, nb * kBox * sizeof(float), p);
}

__global__ void __launch_bounds__(kThreads, 1)
conv_bwd_join_kernel(const __grid_constant__ CUtensorMap up_map,
                     const __grid_constant__ CUtensorMap res_map,
                     const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap dy_map,
                     const bf16* __restrict__ w1,
                     const float* __restrict__ mu_in, int64_t m, int nj, int n,
                     int stages, float* __restrict__ partial) {
  // layout: stages (kb boxes of dy_up, nb of dy_res then dy, nb of x_raw)
  // | w1 (kb boxes of nb * 64 rows) | mu | full and empty barriers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kb = (n + kBox - 1) / kBox, nb = (nj + kBox - 1) / kBox;
  const int stage_bytes = (kb + 2 * nb) * kBoxBytes;
  uint8_t* sw = ring + stages * stage_bytes;
  float* smu = reinterpret_cast<float*>(sw + kb * nb * kBoxBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smu + nb * kBox);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fill_weight(sw, w1, n, nj, kb, nb, true, tid, kThreads);
  for (int i = tid; i < nb * kBox; i += kThreads)
    smu[i] = i < nj ? mu_in[i] : 0.f;
  fence_async_smem();
  __syncthreads();

  const int64_t tiles = (m + kRows - 1) / kRows;
  if (warp == kConsumers * 4) {  // the producer warp
    if (lane == 0) {
      int i = 0;
      for (int64_t tile = blockIdx.x; tile < tiles;
           tile += gridDim.x, ++i) {
        const int s = i % stages;
        uint8_t* st = ring + s * stage_bytes;
        const int row0 = static_cast<int>(tile * kRows);
        mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], stage_bytes);
        load_boxes(&up_map, kb, st, row0, &full[s]);
        load_boxes(&res_map, nb, st + kb * kBoxBytes, row0, &full[s]);
        load_boxes(&x_map, nb, st + (kb + nb) * kBoxBytes, row0, &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4, t = tid % 128, w4 = warp % 4;
  float run[kMaxChunks][3][2] = {};
  int i = wg;
  for (int64_t tile = blockIdx.x + wg * gridDim.x; tile < tiles;
       tile += kConsumers * gridDim.x, i += kConsumers) {
    const int s = i % stages;
    uint8_t* st = ring + s * stage_bytes;
    mbar_wait(&full[s], (i / stages) & 1);

    const int64_t row0 = tile * kRows;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nb) {  // not `break`: run[c] must stay in registers
        float d[32];
        product(d, st, sw, nb * kBoxBytes, c, kb);
        uint8_t* res = st + (kb + c) * kBoxBytes;
        const uint8_t* xr = st + (kb + nb + c) * kBoxBytes;
        // column group j: dy of both rows stored over dy_res, their sums in
        // v[sum][col]
        auto group = [&](int j, float (&v)[3][2]) {
          const int col = 8 * j + 2 * (lane & 3);
          const float2 mu =
              *reinterpret_cast<const float2*>(smu + c * kBox + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i0 = 4 * j + 2 * h;
            const int r = 16 * w4 + 8 * h + (lane >> 2);
            __nv_bfloat162* rp =
                reinterpret_cast<__nv_bfloat162*>(res + swz(r, col));
            const float2 rv = __bfloat1622float2(*rp);
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xr + swz(r, col)));
            const float2 dx =
                __bfloat1622float2(__floats2bfloat162_rn(d[i0], d[i0 + 1]));
            const float xc0 = __fsub_rn(xv.x, mu.x);
            const float xc1 = __fsub_rn(xv.y, mu.y);
            float d0 = round_bf16(__fadd_rn(dx.x, rv.x));
            float d1 = round_bf16(__fadd_rn(dx.y, rv.y));
            d0 = xc0 > 0.f ? d0 : 0.f;
            d1 = xc1 > 0.f ? d1 : 0.f;
            *rp = __floats2bfloat162_rn(d0, d1);
            if (row0 + r >= m) d0 = d1 = 0.f;
            if (h == 0) {
              v[0][0] = d0;
              v[0][1] = d1;
              v[1][0] = d0 * xc0;
              v[1][1] = d1 * xc1;
              v[2][0] = d0 * d0;
              v[2][1] = d1 * d1;
            } else {
              v[0][0] += d0;
              v[0][1] += d1;
              v[1][0] = fmaf(d0, xc0, v[1][0]);
              v[1][1] = fmaf(d1, xc1, v[1][1]);
              v[2][0] = fmaf(d0, d0, v[2][0]);
              v[2][1] = fmaf(d1, d1, v[2][1]);
            }
          }
        };
        float u[3][2][4];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          float lo[3][2], hi[3][2];
          group(k4, lo);
          group(k4 + 4, hi);
#pragma unroll
          for (int e = 0; e < 6; ++e)
            u[e / 2][e % 2][k4] = rs_first(lo[e / 2][e % 2], hi[e / 2][e % 2],
                                           lane);
        }
#pragma unroll
        for (int e = 0; e < 6; ++e)
          run[c][e / 2][e % 2] += rs_rest(u[e / 2][e % 2], lane);
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if (t == 0) {
      for (int c = 0; c < nb; ++c)
        tma_store(&dy_map, st + (kb + c) * kBoxBytes, c * kBox,
                  static_cast<int>(row0));
      tma_store_drain();
      mbar_arrive(&empty[s]);
    }
  }
  write_partial_row<3>(run, nb, nj, reinterpret_cast<float*>(ring), partial);
}

}  // namespace

// dy_up: (m, n) bf16, w1: (nj, n) bf16, dy_res and x_raw: (m, nj) bf16,
// mu: nj floats, all 16-byte aligned; n, nj multiples of 16, nj <= 256,
// the plan within 227 KB of shared memory (ops/conv_chain.py:_plan).
// dy: (m, nj) bf16. partial: max_blocks * 3nj floats. out: 3nj floats,
// [sum dy | sum dy * xc | sum dy^2]. Returns a CUDA error code, 0 when
// both passes were launched.
extern "C" int conv_bwd_join_launch(const void* dy_up, const void* w1,
                                    const void* dy_res, const void* x_raw,
                                    const void* mu, long long m, int nj,
                                    int n, void* dy, void* partial,
                                    int max_blocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan plan;
  if (!join_plan(nj, n, &plan)) return cudaErrorInvalidValue;
  CUtensorMap up_map, res_map, x_map, dy_map;
  cudaError_t e = tensor_map(&up_map, dy_up, m, n);
  if (e == cudaSuccess) e = tensor_map(&res_map, dy_res, m, nj);
  if (e == cudaSuccess) e = tensor_map(&x_map, x_raw, m, nj);
  if (e == cudaSuccess) e = tensor_map(&dy_map, dy, m, nj);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = 0;
  e = persistent_grid(conv_bwd_join_kernel, plan.smem, m, max_blocks, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_bwd_join_kernel<<<grid, kThreads, plan.smem, st>>>(
      up_map, res_map, x_map, dy_map, static_cast<const bf16*>(w1),
      static_cast<const float*>(mu), m, nj, n, plan.stages,
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(column_sums(static_cast<const float*>(partial),
                                      grid, 3 * nj,
                                      static_cast<float*>(out), st));
}
