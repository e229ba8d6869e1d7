// Native batch gather for the host-stream input path of stil_tta_torch
// (the port's own copy of stil_tta_tpu/data/native/loader.cpp).
//
// Assembling a contiguous batch from a memmapped split by row indices is
// a memory-bandwidth problem that numpy's fancy indexing serialises
// behind the GIL. These functions copy the rows with a small pool of
// threads; Python calls them through ctypes, which releases the GIL for
// the call (stil_tta_torch/data/native_loader.py builds this file with
// g++ at first use). The destination may be any caller-owned buffer,
// such as a pinned host tensor, so a batch is copied once on the host.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run worker() on n_threads threads (the caller's thread is one of them).
template <typename F>
void run_striped(int n_threads, F worker) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather rows of `row_bytes` bytes from `src` at `idx[0..n_idx)` into
// contiguous `dst`. Rows are independent; work is striped over threads.
void gather_rows(const uint8_t* src, const int64_t* idx, int64_t n_idx,
                 int64_t row_bytes, uint8_t* dst, int n_threads) {
  std::atomic<int64_t> next(0);
  run_striped(n_threads, [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n_idx) return;
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  });
}

// Gather uint8 rows of `row_elems` values and write them as float32
// multiplied by `scale` in the same pass (the 1/255 normalisation fused
// into the copy).
void gather_rows_u8_to_f32(const uint8_t* src, const int64_t* idx,
                           int64_t n_idx, int64_t row_elems, float* dst,
                           float scale, int n_threads) {
  std::atomic<int64_t> next(0);
  run_striped(n_threads, [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n_idx) return;
      const uint8_t* s = src + idx[i] * row_elems;
      float* d = dst + i * row_elems;
      for (int64_t j = 0; j < row_elems; ++j)
        d[j] = static_cast<float>(s[j]) * scale;
    }
  });
}

}  // extern "C"
