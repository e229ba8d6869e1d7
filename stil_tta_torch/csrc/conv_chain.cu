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
// Per tile of kRows rows: the block reads raw with 16-byte loads, applies
// the prologue h = max(bf16(bf16(raw * bf16(A)) + bf16(B)), 0) with one
// bfloat16 rounding after each op, as the Pallas body's bf16 arithmetic
// does, and stores h into padded shared memory (rows past M are zero).
// Each warp multiplies its 16 rows of h by the whole weight, which sits in
// shared memory for the block's life, with bf16 wmma products accumulated
// in float32; the epilogue rounds y to bfloat16, stores it and adds y and
// y^2 of the rows below M to the column sums.
//
// Bound: device-memory bandwidth. At the probe's shape (M = 524,288,
// K = 256, N = 64) the kernel must read raw (268.4 MB) and write y
// (67.1 MB): 0.1002 ms at 3.35 TB/s, against 17.18 GFLOP, 0.0174 ms at
// the H100's 989 TFLOP/s bf16. The design reads raw once with coalesced
// 16-byte loads, keeps h and the weight out of device memory and runs
// several blocks per SM so one block's loads overlap another's products.
// It is the simple first version: no TMA, no wgmma, no double buffering.

#include "conv_chain_common.cuh"

namespace {

using namespace conv_chain_common;

// v holds eight bfloat16 values of raw at columns c..c+7; a and b the
// bfloat16-rounded A and B of those columns.
__device__ __forceinline__ void prologue(uint4& v, const float* a,
                                         const float* b) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    x.x = round_bf16(__fadd_rn(round_bf16(__fmul_rn(x.x, a[2 * i])),
                               b[2 * i]));
    x.y = round_bf16(__fadd_rn(round_bf16(__fmul_rn(x.y, a[2 * i + 1])),
                               b[2 * i + 1]));
    x.x = x.x < 0.f ? 0.f : x.x;
    x.y = x.y < 0.f ? 0.f : x.y;
    h[i] = __floats2bfloat162_rn(x.x, x.y);
  }
}

size_t chain_smem(int k, int n) {
  return sizeof(float) * (kWarps * kStage + 2 * k + kWarps * 2 * n) +
         sizeof(bf16) * (static_cast<size_t>(k) * (n + kPad) +
                         static_cast<size_t>(kRows) * (k + kPad));
}

template <bool STATS_FROM_F32>
__global__ void __launch_bounds__(kThreads)
conv_chain_kernel(const bf16* __restrict__ raw, const bf16* __restrict__ w,
                  const float* __restrict__ a_in,
                  const float* __restrict__ b_in, int64_t m, int k, int n,
                  bf16* __restrict__ y, float* __restrict__ partial) {
  // layout: staging squares | w (k, n + kPad) | h (kRows, k + kPad) |
  // bf16(A) | bf16(B) | per-warp sums (kWarps, 2n); each piece starts on
  // a 32-byte boundary as wmma needs (k and n are multiples of 16)
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldw = n + kPad, ldh = k + kPad;
  float* stage = reinterpret_cast<float*>(smem);
  bf16* sw = reinterpret_cast<bf16*>(stage + kWarps * kStage);
  bf16* sh = sw + k * ldw;
  float* sa = reinterpret_cast<float*>(sh + kRows * ldh);
  float* sb = sa + k;
  float* acc = sb + k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cp = lane % 8, rg = lane / 8;
  float* my_stage = stage + warp * kStage;
  float* my_acc = acc + warp * 2 * n;

  copy_to_shared(sw, ldw, w, k, n);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    sa[i] = round_bf16(a_in[i]);
    sb[i] = round_bf16(b_in[i]);
  }
  for (int i = threadIdx.x; i < kWarps * 2 * n; i += kThreads) acc[i] = 0.f;

  const int units_per_row = k / 8;
  const int units = kRows * units_per_row;
  const uint4* raw4 = reinterpret_cast<const uint4*>(raw);
  const int64_t tiles = (m + kRows - 1) / kRows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kRows;
    __syncthreads();  // the previous tile's h is consumed
    // eight 16-byte loads in flight per thread, then the prologue
    constexpr int kBatch = 8;
    for (int u0 = threadIdx.x; u0 < units; u0 += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kThreads;
        const int64_t row = row0 + u / units_per_row;
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (u < units && row < m)
          v[j] = __ldg(raw4 + row * units_per_row + u % units_per_row);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kThreads;
        if (u < units) {
          const int r = u / units_per_row, c = (u % units_per_row) * 8;
          if (row0 + r < m) prologue(v[j], sa + c, sb + c);
          *reinterpret_cast<uint4*>(sh + r * ldh + c) = v[j];
        }
      }
    }
    __syncthreads();

    const int64_t strip0 = row0 + warp * 16;
    strip_product<true>(
        sh + warp * 16 * ldh, ldh, sw, ldw, k, n, my_stage, [&](int col) {
          float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rg + 4 * i;
            const int64_t row = strip0 + r;
            if (row < m) {
              const float2 v = *reinterpret_cast<const float2*>(
                  my_stage + r * 16 + 2 * cp);
              const __nv_bfloat162 vb = __floats2bfloat162_rn(v.x, v.y);
              *reinterpret_cast<__nv_bfloat162*>(y + row * n + col + 2 * cp) =
                  vb;
              const float2 t = STATS_FROM_F32 ? v : __bfloat1622float2(vb);
              s1[0] += t.x;
              s1[1] += t.y;
              s2[0] = fmaf(t.x, t.x, s2[0]);
              s2[1] = fmaf(t.y, t.y, s2[1]);
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            s1[q] = sum_row_groups(s1[q]);
            s2[q] = sum_row_groups(s2[q]);
          }
          if (lane < 8) {
            const int c = col + 2 * cp;
            my_acc[c] += s1[0];
            my_acc[c + 1] += s1[1];
            my_acc[n + c] += s2[0];
            my_acc[n + c + 1] += s2[1];
          }
        });
  }
  write_partial_row(acc, 2 * n, partial);
}

template <bool STATS_FROM_F32>
int launch(const void* raw, const void* w, const void* a, const void* b,
           long long m, int k, int n, void* y, void* partial, int max_blocks,
           void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = chain_smem(k, n);
  auto kernel = conv_chain_kernel<STATS_FROM_F32>;
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, smem, m, max_blocks, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(raw), static_cast<const bf16*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b), m, k, n,
      static_cast<bf16*>(y), static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(column_sums(static_cast<const float*>(partial),
                                      grid, 2 * n, static_cast<float*>(out),
                                      st));
}

}  // namespace

// raw: (m, k) bf16, w: (k, n) bf16, a, b: k floats, all 16-byte aligned;
// k, n multiples of 16. y: (m, n) bf16. partial: max_blocks * 2n floats.
// out: 2n floats, [sum y | sum y^2]. Returns a CUDA error code, 0 when
// both passes were launched.
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
