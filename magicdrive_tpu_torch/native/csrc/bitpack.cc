// Bit-pack codec of the BEV mask cache (the port's copy of the JAX
// package's native/csrc/bitpack.cc; ref:magicdrive/dataset/
// pipeline_utils.py:10-49 one_hot_encode/decode). Packs up to 30 binary
// (C, H, W) mask channels into one int32 plane; decode reverses it.
//
// A plain C interface, bound with ctypes (native/bitpack.py).

#include <cstdint>

extern "C" {

// masks: (C, N) uint8 row-major (N = H*W), out: (N,) int32; bit c is set
// where channel c is non-zero
void bitpack_encode(const uint8_t* masks, int32_t channels, int64_t n,
                    int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = 0;
  for (int32_t c = 0; c < channels; ++c) {
    const uint8_t* row = masks + static_cast<int64_t>(c) * n;
    const int32_t bit = 1 << c;
    for (int64_t i = 0; i < n; ++i) {
      out[i] |= row[i] ? bit : 0;
    }
  }
}

// packed: (N,) int32, out: (C, N) uint8
void bitpack_decode(const int32_t* packed, int32_t channels, int64_t n,
                    uint8_t* out) {
  for (int32_t c = 0; c < channels; ++c) {
    uint8_t* row = out + static_cast<int64_t>(c) * n;
    const int32_t bit = 1 << c;
    for (int64_t i = 0; i < n; ++i) {
      row[i] = (packed[i] & bit) ? 1 : 0;
    }
  }
}

}  // extern "C"
