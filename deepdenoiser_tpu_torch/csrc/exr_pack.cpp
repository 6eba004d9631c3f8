// The EXR codec's ZIP pre- and post-processing, on the host
// (deepdenoiser_tpu_torch/data/exr_codec.py, bound in data/_native.py).
//
// The port's copy of native/exr_pack.cpp: the same two functions, byte for
// byte the same results. OpenEXR's ZIP packing splits a block's bytes into
// even and odd halves and applies a byte-delta predictor before zlib; the
// predictor is a sequential scan, which numpy does in several passes over
// int16/int64 copies of the block. Here each direction is one pass over
// the buffer. Compression itself stays in zlib. This is host code, not a
// device kernel: the codec reads and writes files on the host in both
// packages. The numpy versions (exr_codec._zip_*_np) are the plain
// versions the tests hold these to, bit for bit.
//
// Built at first use by ops/_build.py with the host compiler
// (c++ -O3 -fPIC -shared -std=c++17, native/Makefile's flags) into
// build/torch_kernels/, and loaded with ctypes.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// OpenEXR ZIP "compress" preprocessing:
//   1) interleave-split: even-index bytes to the first half, odd to the second
//   2) delta predictor: d[0] = t[0]; d[i] = t[i] - t[i-1] + 128  (mod 256)
// dst and src must not alias; n may be odd.
void exr_split_and_predict(const uint8_t* src, uint8_t* dst, size_t n) {
    if (n == 0) return;
    const size_t half = (n + 1) / 2;
    for (size_t i = 0, j = 0; j < half; i += 2, ++j) dst[j] = src[i];
    for (size_t i = 1, j = half; j < n; i += 2, ++j) dst[j] = src[i];
    // predict in place, carrying the previous original byte
    uint8_t prev = dst[0];
    for (size_t i = 1; i < n; ++i) {
        const uint8_t cur = dst[i];
        dst[i] = static_cast<uint8_t>(cur - prev + 128u);
        prev = cur;
    }
}

// Inverse: undo the predictor (raw[0] = src[0]; raw[i] = raw[i-1] + src[i]
// - 128), then merge the halves back into interleaved order. dst and src
// must not alias.
void exr_unpredict_and_merge(const uint8_t* src, uint8_t* dst, size_t n) {
    if (n == 0) return;
    const size_t half = (n + 1) / 2;
    std::vector<uint8_t> raw(n);
    uint8_t prev = src[0];
    raw[0] = prev;
    for (size_t i = 1; i < n; ++i) {
        prev = static_cast<uint8_t>(prev + src[i] - 128u);
        raw[i] = prev;
    }
    for (size_t i = 0, j = 0; j < half; i += 2, ++j) dst[i] = raw[j];
    for (size_t i = 1, j = half; j < n; i += 2, ++j) dst[i] = raw[j];
}

}  // extern "C"
