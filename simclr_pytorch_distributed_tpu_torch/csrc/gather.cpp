// Native host-side batch gather for the port's data pipeline (the port's
// own copy of the JAX package's native/gather.cpp).
//
// The one hot host op left once augmentation runs on the device is
// assembling a uint8 batch from a shuffled index set: EpochLoader's batches
// and WindowStore's windows (data/pipeline.py, data/device_store.py). This
// library does that gather with one memcpy per row and no Python objects,
// and is called through ctypes, which releases the GIL, so the prefetch
// thread's gather overlaps the device step.
//
// Built at first use with g++ -O3 -shared -fPIC (data/native_gather.py);
// a plain C ABI, no Python or PyTorch headers.

#include <cstdint>
#include <cstring>

extern "C" {

// dst[i, :] = src[idx[i], :] for row_bytes-sized rows.
void gather_rows_u8(const uint8_t* src, const int64_t* idx, int64_t n_idx,
                    int64_t row_bytes, uint8_t* dst) {
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

// int32 label gather (labels are 4-byte scalars).
void gather_rows_i32(const int32_t* src, const int64_t* idx, int64_t n_idx,
                     int32_t* dst) {
  for (int64_t i = 0; i < n_idx; ++i) {
    dst[i] = src[idx[i]];
  }
}

}  // extern "C"
