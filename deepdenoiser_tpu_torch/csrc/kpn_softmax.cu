// The KPN head's per-slot logits -> filter weights for Hopper (sm_90a), fp32,
// in one pass:
//
//   norm on:   rms = sqrt(mean_t(l_t^2) + 1e-8),  z_t = l_t / rms * tau
//   norm off:  z_t = l_t
//   w_t = exp(z_t - max_t z) / sum_t exp(z_t - max_t z)
//
// over the k*k taps t of every pixel, k in {3, 5}, with the arithmetic and
// the order of operations of the plain version (ops/kpn_softmax.py,
// softmax_plain): the mean as the sum times 1/k^2, full-precision expf,
// sqrtf and divisions (no fast-math intrinsics).
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched). `logits` is an (n, h, w, k2) view with element strides
// sn, sy, sx and contiguous taps; `out` a contiguous (n, h, w, k2) tensor,
// 16 B aligned. `tau` null: no norm; else it points to the norm's
// temperature, read on the device. The caller checks shapes and strides and
// that n*h*w*k2 fits in an int; k2 other than 9 or 25, or an empty launch,
// return cudaErrorInvalidValue without launching.
extern "C" int kpn_softmax_f32(const float* logits, const float* tau, float* out, int n, int h,
                               int w, int k2, long long sn, long long sy, long long sx,
                               void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = static_cast<long long>(n) * h * w;
  if (npix * k2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
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
  return static_cast<int>(cudaErrorInvalidValue);
}
