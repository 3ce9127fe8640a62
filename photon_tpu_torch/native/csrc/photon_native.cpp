// photon_tpu_torch native host helpers (built with g++ on first use by
// photon_tpu_torch/native/__init__.py; loaded with ctypes, plain C ABI).
// Host-side only: the device work is torch's and the CUDA kernels'.
//
//   pts_gather_widen : batch-gather PTS sample rows (uint16/uint32) into a
//                      contiguous int32 batch (the data loader's gather).
//   par_memcpy       : multi-threaded memcpy (the shm plane's bulk copy).
//   crc32            : zlib-polynomial CRC-32, table-based, outside the GIL.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather n_rows rows into out[int32]. row_ptrs[i] points at row i's first
// token (uint16 when elem_size==2, uint32 when 4); each row has row_elems
// tokens. Fuses the gather with the int32 widen so the batch is written once.
void pts_gather_widen(const void** row_ptrs, int64_t n_rows, int64_t row_elems,
                      int elem_size, int32_t* out, int n_threads) {
  if (n_rows <= 0) return;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_rows) n_threads = (int)n_rows;

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t* dst = out + i * row_elems;
      if (elem_size == 2) {
        const uint16_t* src = (const uint16_t*)row_ptrs[i];
        for (int64_t j = 0; j < row_elems; ++j) dst[j] = (int32_t)src[j];
      } else {
        const uint32_t* src = (const uint32_t*)row_ptrs[i];
        for (int64_t j = 0; j < row_elems; ++j) dst[j] = (int32_t)src[j];
      }
    }
  };

  if (n_threads == 1) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk > n_rows ? n_rows : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back(worker, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// Multi-threaded memcpy for large buffers (>= ~8 MiB pays off).
void par_memcpy(void* dst, const void* src, int64_t n, int n_threads) {
  if (n <= 0) return;
  const int64_t kMin = 8 << 20;
  if (n_threads < 1) n_threads = 1;
  int64_t max_threads = n / kMin;
  if (max_threads < 1) max_threads = 1;
  if (n_threads > max_threads) n_threads = (int)max_threads;
  if (n_threads == 1) {
    std::memcpy(dst, src, (size_t)n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back([=] {
      std::memcpy((char*)dst + lo, (const char*)src + lo, (size_t)(hi - lo));
    });
  }
  for (auto& th : ts) th.join();
}

// zlib-compatible CRC-32 (polynomial 0xEDB88320), table-based.
static uint32_t crc_table[256];
static std::atomic<bool> crc_init{false};

static void ensure_crc_table() {
  bool expected = false;
  static std::atomic<bool> building{false};
  if (crc_init.load(std::memory_order_acquire)) return;
  if (building.compare_exchange_strong(expected, true)) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
    crc_init.store(true, std::memory_order_release);
  } else {
    while (!crc_init.load(std::memory_order_acquire)) {}
  }
}

uint32_t crc32(uint32_t seed, const void* buf, int64_t n) {
  ensure_crc_table();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  const uint8_t* p = (const uint8_t*)buf;
  for (int64_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
