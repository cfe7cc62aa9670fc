// Host-side batch gather of the port's input pipeline (the counterpart of
// the JAX package's native/gather.cpp; reference src/util.py:508-516, a
// per-sample h5py read and numpy transpose).
//
// SliceDataset.get_batch (data/dataset.py) packs a whole batch with ONE
// call: for every (modality, sample) task it copies a contiguous depth
// block [bc, H, W] out of the depth-major source volume and transposes it
// to the batch layout [H, W, bc], or zero-fills the task when the modality
// is absent (the reference's missing-modality contract,
// src/util.py:512-514).
//
// The work is a strided memory copy, spread over a small thread pool: as
// many threads as the host has cores (hardware_concurrency), or
// RDT_NATIVE_THREADS.  native/__init__.py builds it with g++ -O3 at first
// use and binds it with ctypes; the numpy branch of get_batch gives the
// same batches.
//
// C ABI only (loaded via ctypes): no C++ types in the signatures.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One gather task: src points at the block start (= &vol[sl - b, 0, 0]),
// laid out [bc, H, W] contiguous; dst is [H, W, bc] contiguous.
// src == nullptr means "modality absent": zero-fill dst.
void gather_one(const float* src, float* dst, int64_t H, int64_t W,
                int64_t bc) {
  if (src == nullptr) {
    std::memset(dst, 0, sizeof(float) * H * W * bc);
    return;
  }
  const int64_t plane = H * W;
  for (int64_t h = 0; h < H; ++h) {
    const float* row = src + h * W;        // plane 0, row h
    float* out_row = dst + h * W * bc;
    for (int64_t w = 0; w < W; ++w) {
      float* out = out_row + w * bc;       // contiguous 7-wide write
      const float* in = row + w;           // strided reads, one per plane
      for (int64_t c = 0; c < bc; ++c) out[c] = in[c * plane];
    }
  }
}

int pool_size() {
  const char* env = std::getenv("RDT_NATIVE_THREADS");
  if (env != nullptr) {
    int n = std::atoi(env);
    if (n > 0) return n;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw > 0 ? static_cast<int>(hw) : 1;
}

}  // namespace

extern "C" {

// srcs: [n_tasks] array of block-start pointers (0 => zero-fill).
// dst:  [n_tasks, H, W, bc] contiguous float32 output.
// Returns 0 on success.
int rdt_gather_blocks(const float** srcs, float* dst, int64_t n_tasks,
                      int64_t H, int64_t W, int64_t bc) {
  if (n_tasks <= 0) return 0;
  const int64_t task_elems = H * W * bc;
  const int n_threads_wanted = pool_size();
  const int n_threads =
      static_cast<int>(n_tasks < n_threads_wanted ? n_tasks
                                                  : n_threads_wanted);
  if (n_threads <= 1) {
    for (int64_t t = 0; t < n_tasks; ++t)
      gather_one(srcs[t], dst + t * task_elems, H, W, bc);
    return 0;
  }
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t t = next.fetch_add(1, std::memory_order_relaxed);
      if (t >= n_tasks) return;
      gather_one(srcs[t], dst + t * task_elems, H, W, bc);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads - 1);
  for (int i = 0; i < n_threads - 1; ++i) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return 0;
}

// ABI version handshake so a stale cached .so is never used silently.
int rdt_native_abi_version() { return 1; }

}  // extern "C"
