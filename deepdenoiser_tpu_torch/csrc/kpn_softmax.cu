// The KPN head's per-slot logits -> filter weights for Hopper (sm_90a), fp32,
// in one pass:
//
//   norm on:   rms = sqrt(mean_t(l_t^2) + 1e-8),  z_t = l_t / rms * tau
//   norm off:  z_t = l_t
//   w_t = exp(z_t - max_t z) / sum_t exp(z_t - max_t z)
//
// over the k*k taps t of every pixel, k in {3, 5} (k = 21: the warp form
// below), with the arithmetic and the order of operations of the plain
// version (ops/kpn_softmax.py, softmax_plain): the mean as the sum times
// 1/k^2, full-precision expf, sqrtf and divisions (no fast-math intrinsics).
//
// It replaces no TPU kernel: the JAX head (deepdenoiser_tpu/models/kpn.py)
// leaves this chain to XLA, which fuses it. In PyTorch the chain was six
// passes over each slot's strided logits (square, mean, add, sqrt, divide,
// scale, softmax), each reading and writing the slot's taps again.
//
// What bounds it: memory. A pixel's slot is k*k floats read and k*k written
// with a few dozen operations between them. The logits are a slot view of
// the backbone's (N, H, W, n_slots*k*k) output: a run of k*k contiguous
// floats (100 B at k = 5) every n_slots*k*k floats (800 B in kpn-hq, 200 B
// in flagship-max). A 100 B run lies in four 32 B sectors whatever its
// start, so a launch moves at least 128 B read and 100 B written a pixel at
// k = 5: at the kpn-hq 1080p plane (1, 1144, 1984) that is 518 MB, 155 us at
// 3.35 TB/s (454 MB of useful bytes, 136 us). The output is the contiguous
// (N, H, W, k*k) tensor that the filter apply (kpn_apply.cu) stages in 16 B
// copies.
//
// The design, against that bound:
//   - A block of NT = 128 threads owns PX = 128 consecutive pixels of the
//     (N, H, W) order. Each thread first finds the address of its own
//     pixel's run through the view's strides (any N, H and W strides; the
//     taps are contiguous).
//   - Load: the block's PX runs, concatenated, are PX*k*k floats; thread i
//     loads words i, i + NT, ... of that sequence, k*k of them, all issued
//     before the first is used. A warp's 32 loads fall in a few neighbouring
//     runs, so every sector a run touches is fetched once, and each thread has
//     k*k loads in flight. They land in shared memory in the same order:
//     the rows of the block, each k*k floats.
//   - Compute: thread i takes pixel i's row. The row stride, k*k, is odd,
//     so a warp's 32 reads hit 32 different banks. The norm and the
//     softmax run in registers; the weights go back over the row.
//   - Store: the block's output is one contiguous span of PX*k*k floats,
//     16 B aligned (PX*k*k*4 is a multiple of 16), written in 16 B stores,
//     neighbouring lanes on neighbouring 16 bytes; a ragged last block
//     ends with scalar stores.
//   - The logits are read once and the weights written once: nothing else
//     touches device memory. At k = 5 a block takes 12.8 KB of shared
//     memory and 46 registers a thread, so 10 blocks are resident on an SM,
//     each with PX*k*k loads in flight: far more than the bytes in flight
//     that cover DRAM latency.
//
// What the card reaches (NVIDIA H100 80GB HBM3, 700 W): it fetches these
// scattered runs from memory in 64 B blocks, two or three a run (160 B a
// pixel on average in kpn-hq's layout), so the floor of the kpn-hq 1080p
// launch is 590 MB, 176 us. The kernel takes about 213 us there, faster
// than PyTorch's strided copy of the same slot (about 235 us), which moves
// the same bytes. Blocks of 64 or 256 threads, two pixels a thread,
// streaming cache hints, a register cap for 12 or 16 blocks an SM and a
// 32 B L2 fetch granularity were each no faster.
//
// The k*k = 441 form (k = 21, the KPCN's head) keeps neither the row in
// registers nor the block's rows in shared memory: 441 floats a thread and
// 128 rows a block (226 KB) fit in neither. It takes a warp a pixel
// (kpn_softmax_kernel_warp): lane l loads taps l, l + 32, ... of the run (14
// of them, all in flight before the first is used; a warp instruction reads 32
// neighbouring taps, one or two 32 B sectors of bf16 logits), the max and
// the sum are warp shuffles (an xor butterfly: every lane ends with the same
// bits), and lane l stores the same taps of the contiguous output row. It
// reads the logits in place in fp32 or bf16 (the KPCN's trunk emits bf16;
// an fp32 copy would add 15.8 GB at its 1080p plane), computes in fp32 and
// writes fp32. At that plane the output of one slot, (4, 1136, 1976, 441),
// has 3.96e9 elements: every offset is 64-bit, pixel indices stay 32-bit.
// The sums are a lane's taps in order, then the butterfly: not the plain
// version's order, so it agrees with it to rounding, not bit for bit.
// Memory bounds it: 882 B of bf16 read and 1764 B written a pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads a block
constexpr int PX = NT;   // pixels a block: a pixel a thread in the compute

template <int K2, bool NORM>
__global__ void __launch_bounds__(NT)
kpn_softmax_kernel(const float* __restrict__ logits, const float* __restrict__ tau,
                   float* __restrict__ out, int npix, int h, int w,
                   long long sn, long long sy, long long sx) {
  static_assert((PX * K2) % 4 == 0, "a block's output span must be whole 16 B words");
  __shared__ __align__(16) float rows[PX * K2];
  __shared__ long long base[PX];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PX;
  const int cols = min(PX, npix - p0);  // pixels of this block
  if (tid < cols) {
    const int p = p0 + tid;
    const int hw = h * w;
    const int n = p / hw;
    const int r = p - n * hw;
    const int y = r / w;
    const int x = r - y * w;
    base[tid] = n * sn + y * sy + x * sx;
  }
  __syncthreads();

  // word e = tid + j*NT of the block's concatenated rows: pixel e / K2, tap e % K2
  float v[K2];
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    const int e = tid + j * NT;
    const int px = e / K2;
    v[j] = px < cols ? __ldg(logits + base[px] + (e - px * K2)) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < K2; ++j) rows[tid + j * NT] = v[j];
  __syncthreads();

  float* row = rows + tid * K2;
  float z[K2];
#pragma unroll
  for (int t = 0; t < K2; ++t) z[t] = row[t];
  if (NORM) {
    float ss = 0.0f;
#pragma unroll
    for (int t = 0; t < K2; ++t) ss += __fmul_rn(z[t], z[t]);  // rounded as l*l is, no FMA
    const float rms = sqrtf(ss * (1.0f / K2) + 1e-8f);
    const float scale = __ldg(tau);
#pragma unroll
    for (int t = 0; t < K2; ++t) z[t] = z[t] / rms * scale;
  }
  float m = z[0];
#pragma unroll
  for (int t = 1; t < K2; ++t) m = fmaxf(m, z[t]);
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < K2; ++t) {
    z[t] = expf(z[t] - m);
    sum += z[t];
  }
#pragma unroll
  for (int t = 0; t < K2; ++t) row[t] = z[t] / sum;
  __syncthreads();

  float* span = out + static_cast<long long>(p0) * K2;
  const int nel = cols * K2;
  const int quads = nel / 4;
  for (int q = tid; q < quads; q += NT) {
    reinterpret_cast<float4*>(span)[q] = reinterpret_cast<const float4*>(rows)[q];
  }
  const int e = 4 * quads + tid;
  if (e < nel) span[e] = rows[e];
}

template <int K2, bool NORM>
cudaError_t launch(const float* logits, const float* tau, float* out, int npix, int h, int w,
                   long long sn, long long sy, long long sx, cudaStream_t stream) {
  const int blocks = (npix + PX - 1) / PX;
  kpn_softmax_kernel<K2, NORM><<<blocks, NT, 0, stream>>>(logits, tau, out, npix, h, w, sn, sy,
                                                          sx);
  return cudaGetLastError();
}

constexpr int WIDE_K2 = 441;        // the warp form's taps: k = 21
constexpr int WPB = 8;              // warps (pixels) a block of the warp form
constexpr int WJ = (WIDE_K2 + 31) / 32;  // taps a lane

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, bool NORM>
__global__ void __launch_bounds__(32 * WPB)
kpn_softmax_kernel_warp(const T* __restrict__ logits, const float* __restrict__ tau,
                        float* __restrict__ out, int npix, int h, int w,
                        long long sn, long long sy, long long sx) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (p >= npix) return;  // a whole warp leaves together
  const int hw = h * w;
  const int n = p / hw;
  const int r = p - n * hw;
  const int y = r / w;
  const int x = r - y * w;
  const T* run = logits + n * sn + y * sy + x * sx;
  float z[WJ];
#pragma unroll
  for (int j = 0; j < WJ; ++j) {
    const int t = lane + 32 * j;
    z[j] = t < WIDE_K2 ? load_f(run + t) : 0.0f;
  }
  if (NORM) {
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < WJ; ++j) ss += __fmul_rn(z[j], z[j]);  // the pad taps add 0
    const float rms = sqrtf(warp_sum(ss) * (1.0f / WIDE_K2) + 1e-8f);
    const float scale = __ldg(tau);
#pragma unroll
    for (int j = 0; j < WJ; ++j) z[j] = z[j] / rms * scale;
  }
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int j = 0; j < WJ; ++j) {
    if (lane + 32 * j < WIDE_K2) m = fmaxf(m, z[j]);
  }
  m = warp_max(m);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < WJ; ++j) {
    z[j] = lane + 32 * j < WIDE_K2 ? expf(z[j] - m) : 0.0f;
    sum += z[j];
  }
  sum = warp_sum(sum);
  float* row = out + static_cast<long long>(p) * WIDE_K2;
#pragma unroll
  for (int j = 0; j < WJ; ++j) {
    const int t = lane + 32 * j;
    if (t < WIDE_K2) row[t] = z[j] / sum;
  }
}

template <typename T, bool NORM>
cudaError_t launch_warp(const T* logits, const float* tau, float* out, int npix, int h, int w,
                        long long sn, long long sy, long long sx, cudaStream_t stream) {
  const int blocks = (npix + WPB - 1) / WPB;
  kpn_softmax_kernel_warp<T, NORM><<<blocks, 32 * WPB, 0, stream>>>(logits, tau, out, npix, h, w,
                                                                    sn, sy, sx);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched). `logits` is an (n, h, w, k2) view with element strides
// sn, sy, sx and contiguous taps; `out` a contiguous (n, h, w, k2) tensor,
// 16 B aligned. `tau` null: no norm; else it points to the norm's
// temperature, read on the device. The caller checks shapes and strides and
// that n*h*w fits in an int; k2 other than 9, 25 or 441, or an empty
// launch, return cudaErrorInvalidValue without launching.
extern "C" int kpn_softmax_f32(const float* logits, const float* tau, float* out, int n, int h,
                               int w, int k2, long long sn, long long sy, long long sx,
                               void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = static_cast<long long>(n) * h * w;
  if (npix > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(npix);
  if (k2 == 25) {
    return static_cast<int>(tau ? launch<25, true>(logits, tau, out, np, h, w, sn, sy, sx, st)
                                : launch<25, false>(logits, tau, out, np, h, w, sn, sy, sx, st));
  }
  if (k2 == 9) {
    return static_cast<int>(tau ? launch<9, true>(logits, tau, out, np, h, w, sn, sy, sx, st)
                                : launch<9, false>(logits, tau, out, np, h, w, sn, sy, sx, st));
  }
  if (k2 == WIDE_K2) {
    return static_cast<int>(
        tau ? launch_warp<float, true>(logits, tau, out, np, h, w, sn, sy, sx, st)
            : launch_warp<float, false>(logits, tau, out, np, h, w, sn, sy, sx, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for bf16 logits (a uint16 array), k2 = 441 only: the warp form,
// which converts each tap to fp32 as it loads it.
extern "C" int kpn_softmax_bf16(const void* logits, const float* tau, float* out, int n, int h,
                                int w, int k2, long long sn, long long sy, long long sx,
                                void* stream) {
  if (n < 1 || h < 1 || w < 1 || k2 != WIDE_K2) return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = static_cast<long long>(n) * h * w;
  if (npix > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(npix);
  const auto* lg = static_cast<const __nv_bfloat16*>(logits);
  return static_cast<int>(
      tau ? launch_warp<__nv_bfloat16, true>(lg, tau, out, np, h, w, sn, sy, sx, st)
          : launch_warp<__nv_bfloat16, false>(lg, tau, out, np, h, w, sn, sy, sx, st));
}
