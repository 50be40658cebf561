// Native data-plane helpers for the host input pipeline.
//
// The reference's input path is a torch DataLoader with Python-side
// per-sample transforms (reference: src/dataset.py:55-90).  Here the hot
// host work is batch collation (gather cached uint8 sample arrays into a
// padded, contiguous batch buffer).  Doing the copies in C with the GIL
// released (ctypes releases it for the duration of the call) lets the
// producer thread overlap fully with the main thread's step dispatch on the
// single-core TPU host.
//
// Plain C ABI (no CPython/pybind dependency); loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

// Gather n sample buffers of sample_bytes each into dst (capacity
// batch_size * sample_bytes); zero-fill the padded tail rows.
void gml_collate_u8(const uint8_t** srcs, int32_t n, int64_t sample_bytes,
                    uint8_t* dst, int32_t batch_size) {
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(dst + (int64_t)i * sample_bytes, srcs[i], sample_bytes);
  }
  if (n < batch_size) {
    std::memset(dst + (int64_t)n * sample_bytes, 0,
                (int64_t)(batch_size - n) * sample_bytes);
  }
}

// Strided view-select gather: pick `n_views` sub-rows (view_indices) out of
// each sample's leading axis of `total_views` rows of view_bytes each.
void gml_gather_views_u8(const uint8_t** srcs, int32_t n,
                         const int32_t* view_indices, int32_t n_views,
                         int64_t view_bytes, uint8_t* dst,
                         int32_t batch_size) {
  const int64_t sample_bytes = (int64_t)n_views * view_bytes;
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t v = 0; v < n_views; ++v) {
      std::memcpy(dst + (int64_t)i * sample_bytes + (int64_t)v * view_bytes,
                  srcs[i] + (int64_t)view_indices[v] * view_bytes, view_bytes);
    }
  }
  if (n < batch_size) {
    std::memset(dst + (int64_t)n * sample_bytes, 0,
                (int64_t)(batch_size - n) * sample_bytes);
  }
}

}  // extern "C"
