// Helpers shared by the KPN filter apply (kpn_apply.cu) and its backward
// (kpn_apply_bwd.cu): cp.async copies into shared memory, the staging of a
// halo'd window of an (N, H, W, C) tensor given by element strides, and the
// dispatch of runtime k and c to template parameters.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace kpn {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy to shared memory; zero-filled when !in_frame
// (src-size 0: nothing is read, `src` only has to be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in_frame) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in_frame ? 4 : 0));
}

// 16-byte asynchronous copy to shared memory, both addresses 16 B aligned,
// for data read once and whole: .cg keeps it out of L1, and the L2 fetches
// the copy's whole 128 B line.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats between the last 16 B boundary and `p` (0..3).
__device__ __forceinline__ int misalignment(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Issue the copies of the ROWS x COLS x C window whose top-left frame pixel
// is (gy0, gx0) into planar [C][ROWS][ROW] shared memory, zero outside the
// frame; NT threads, thread `tid`. A window row is COLS*C elements in
// pixel-major, channel-minor order: a thread's columns and channels (and
// so its offsets within a row) are the same in every row, and the 32
// copies of one warp instruction read about 11 neighbouring pixels' C
// channels, a few cache lines even at a 96 B pixel stride.
template <int C, int NT, int ROWS, int COLS, int ROW>
__device__ __forceinline__ void stage(float* sm, const float* src, int tid, int gy0, int gx0,
                                      int h, int w, long long sy, long long sx, long long sc) {
  constexpr int RE = COLS * C;
  constexpr int M = (RE + NT - 1) / NT;  // elements of a row per thread
  long long off[M];
  int dst[M];
  bool ok[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int e = tid + m * NT;
    const int col = e / C;
    const int c = e - col * C;
    const int gx = gx0 + col;
    off[m] = gx * sx + c * sc;
    dst[m] = c * ROWS * ROW + col;
    ok[m] = e < RE && gx >= 0 && gx < w;
    if (e >= RE) dst[m] = -1;
  }
#pragma unroll 2
  for (int r = 0; r < ROWS; ++r) {
    const int gy = gy0 + r;
    const bool row_in = gy >= 0 && gy < h;
    const float* rp = src + (row_in ? gy * sy : 0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (dst[m] < 0) continue;
      const bool in = row_in && ok[m];
      cp_async4(sm + dst[m] + r * ROW, in ? rp + off[m] : src, in);
    }
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<K>, Int<C>) for runtime k in {3, 5} and c in 1..4;
// cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t dispatch(int k, int c, F&& f) {
#define KPN_DISPATCH_C(K)                     \
  switch (c) {                                \
    case 1: return f(Int<K>{}, Int<1>{});     \
    case 2: return f(Int<K>{}, Int<2>{});     \
    case 3: return f(Int<K>{}, Int<3>{});     \
    case 4: return f(Int<K>{}, Int<4>{});     \
    default: return cudaErrorInvalidValue;    \
  }
  if (k == 3) KPN_DISPATCH_C(3)
  if (k == 5) KPN_DISPATCH_C(5)
#undef KPN_DISPATCH_C
  return cudaErrorInvalidValue;
}

}  // namespace kpn
