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
// Per tile of kRows rows the block stages dy_up in padded shared memory
// (rows past M are zero); w1, (NJ, N) row-major, sits in shared memory for
// the block's life and is read as the column-major (N, NJ) right operand.
// Each warp multiplies its 16 rows by it with bf16 wmma products
// accumulated in float32; for each 16x16 result the epilogue reads the
// matching dy_res and x_raw values (bfloat16 pairs, 32 contiguous bytes a
// row), forms dy, stores it and adds the three sums.
//
// Bound: device-memory bandwidth. At the probe's shape (M = 524,288,
// N = 64, NJ = 256) the kernel must read dy_up (67.1 MB), dy_res and
// x_raw (268.4 MB each) and write dy (268.4 MB): 872.4 MB, 0.2604 ms at
// 3.35 TB/s, against 17.18 GFLOP, 0.0174 ms at 989 TFLOP/s bf16. The
// design reads each input once and keeps dx out of device memory. It is
// the simple first version: the epilogue's loads are 4 bytes a lane and
// not overlapped with the products beyond what other blocks on the SM
// give.

#include "conv_chain_common.cuh"

namespace {

using namespace conv_chain_common;

size_t join_smem(int nj, int n) {
  return sizeof(float) * (kWarps * kStage + nj + kWarps * 3 * nj) +
         sizeof(bf16) * (static_cast<size_t>(nj) * (n + kPad) +
                         static_cast<size_t>(kRows) * (n + kPad));
}

__global__ void __launch_bounds__(kThreads)
conv_bwd_join_kernel(const bf16* __restrict__ dy_up,
                     const bf16* __restrict__ w1,
                     const bf16* __restrict__ dy_res,
                     const bf16* __restrict__ x_raw,
                     const float* __restrict__ mu_in, int64_t m, int nj, int n,
                     bf16* __restrict__ dy, float* __restrict__ partial) {
  // layout: staging squares | w1 (nj, n + kPad) | dy_up tile (kRows,
  // n + kPad) | mu | per-warp sums (kWarps, 3 nj); each piece starts on a
  // 32-byte boundary as wmma needs (n and nj are multiples of 16)
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = n + kPad;
  float* stage = reinterpret_cast<float*>(smem);
  bf16* sw = reinterpret_cast<bf16*>(stage + kWarps * kStage);
  bf16* su = sw + nj * ld;
  float* smu = reinterpret_cast<float*>(su + kRows * ld);
  float* acc = smu + nj;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cp = lane % 8, rg = lane / 8;
  float* my_stage = stage + warp * kStage;
  float* my_acc = acc + warp * 3 * nj;

  copy_to_shared(sw, ld, w1, nj, n);
  for (int i = threadIdx.x; i < nj; i += kThreads) smu[i] = mu_in[i];
  for (int i = threadIdx.x; i < kWarps * 3 * nj; i += kThreads) acc[i] = 0.f;

  const int units_per_row = n / 8;
  const int units = kRows * units_per_row;
  const uint4* up4 = reinterpret_cast<const uint4*>(dy_up);
  const int64_t tiles = (m + kRows - 1) / kRows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kRows;
    __syncthreads();  // the previous tile's dy_up is consumed
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int r = u / units_per_row, c = (u % units_per_row) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < m)
        v = __ldg(up4 + (row0 + r) * units_per_row + u % units_per_row);
      *reinterpret_cast<uint4*>(su + r * ld + c) = v;
    }
    __syncthreads();

    const int64_t strip0 = row0 + warp * 16;
    strip_product<false>(
        su + warp * 16 * ld, ld, sw, ld, n, nj, my_stage, [&](int col) {
          const int c = col + 2 * cp;
          const float mu0 = smu[c], mu1 = smu[c + 1];
          float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, s3[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rg + 4 * i;
            const int64_t row = strip0 + r;
            if (row < m) {
              const int64_t at = row * nj + c;
              const float2 res = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(dy_res + at));
              const float2 xr = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x_raw + at));
              const float2 v = *reinterpret_cast<const float2*>(
                  my_stage + r * 16 + 2 * cp);
              const float2 dx = __bfloat1622float2(
                  __floats2bfloat162_rn(v.x, v.y));
              const float xc0 = __fsub_rn(xr.x, mu0);
              const float xc1 = __fsub_rn(xr.y, mu1);
              float d0 = round_bf16(__fadd_rn(dx.x, res.x));
              float d1 = round_bf16(__fadd_rn(dx.y, res.y));
              d0 = xc0 > 0.f ? d0 : 0.f;
              d1 = xc1 > 0.f ? d1 : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(dy + at) =
                  __floats2bfloat162_rn(d0, d1);
              s1[0] += d0;
              s1[1] += d1;
              s2[0] = fmaf(d0, xc0, s2[0]);
              s2[1] = fmaf(d1, xc1, s2[1]);
              s3[0] = fmaf(d0, d0, s3[0]);
              s3[1] = fmaf(d1, d1, s3[1]);
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            s1[q] = sum_row_groups(s1[q]);
            s2[q] = sum_row_groups(s2[q]);
            s3[q] = sum_row_groups(s3[q]);
          }
          if (lane < 8) {
            my_acc[c] += s1[0];
            my_acc[c + 1] += s1[1];
            my_acc[nj + c] += s2[0];
            my_acc[nj + c + 1] += s2[1];
            my_acc[2 * nj + c] += s3[0];
            my_acc[2 * nj + c + 1] += s3[1];
          }
        });
  }
  write_partial_row(acc, 3 * nj, partial);
}

}  // namespace

// dy_up: (m, n) bf16, w1: (nj, n) bf16, dy_res and x_raw: (m, nj) bf16,
// mu: nj floats, all 16-byte aligned; n, nj multiples of 16. dy: (m, nj)
// bf16. partial: max_blocks * 3nj floats. out: 3nj floats, [sum dy |
// sum dy * xc | sum dy^2]. Returns a CUDA error code, 0 when both passes
// were launched.
extern "C" int conv_bwd_join_launch(const void* dy_up, const void* w1,
                                    const void* dy_res, const void* x_raw,
                                    const void* mu, long long m, int nj,
                                    int n, void* dy, void* partial,
                                    int max_blocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = join_smem(nj, n);
  int grid = 0;
  cudaError_t e =
      persistent_grid(conv_bwd_join_kernel, smem, m, max_blocks, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_bwd_join_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(dy_up), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(dy_res), static_cast<const bf16*>(x_raw),
      static_cast<const float*>(mu), m, nj, n, static_cast<bf16*>(dy),
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(column_sums(static_cast<const float*>(partial),
                                      grid, 3 * nj,
                                      static_cast<float*>(out), st));
}
