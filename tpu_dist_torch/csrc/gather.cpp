// Native host-side batch gather for the port's data loader
// (tpu_dist_torch.data): the JAX package's csrc/gather.cpp, line for line.
//
// Assembling a batch from sampled row indices memcpy's whole rows instead
// of numpy fancy-indexing element loops, and ctypes releases the GIL for
// the call, so batch assembly in the loader's producer thread overlaps the
// device step.
//
// Build: tpu_dist_torch/native.py (g++ -O3 -fPIC -shared -std=c++17 into
// build/tpu_dist_torch/, with decode.cpp).

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// Gather rows: out[i,:] = src[idx[i],:], row_bytes bytes per row.
void gather_rows_u8(const uint8_t* src, const int64_t* idx, uint8_t* out,
                    int64_t n_rows, int64_t row_bytes) {
    for (int64_t i = 0; i < n_rows; ++i) {
        std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes,
                    (size_t)row_bytes);
    }
}

// Gather int32 labels: out[i] = src[idx[i]].
void gather_i32(const int32_t* src, const int64_t* idx, int32_t* out,
                int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}

}  // extern "C"
