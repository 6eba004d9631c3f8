// Kernel-prediction filter apply for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel deepdenoiser_tpu/ops/kpn_pallas.py::_kernel
// (launched by _apply_planes, public apply_per_pixel_kernels_pallas):
//
//   out[n,y,x,c] = sum_{t<k*k} w[n,y,x,t] * noisy[n, y+t/k-p, x+t%k-p, c]
//
// zero outside the frame, p = k/2, k in {3, 5}, taps summed in fp32 in the
// order t = 0..k*k-1 as the plain version (models/kpn.py) does.
//
// What bounds it: memory. Per pixel it reads C + k*k floats and writes C
// floats; at k=5, C=3 that is 124 B against 150 FLOP (1.2 FLOP/B, far
// below the card's ~20 FLOP/B fp32 balance point). The one thing the
// design does about it: each block stages its (BH+k-1) x (BW+k-1) x C
// noisy tile in shared memory once, zero-filled outside the frame, so the
// k*k taps read shared memory instead of device memory k*k times, and no
// zero-padded copy of the plane is ever made in device memory (the TPU
// kernel DMAs a padded planar copy; that design is not carried over).
//
// Layout: both inputs are taken with element strides. The noisy signal is
// a 3-channel slice of the model's fp32 NHWC input (channel stride 1,
// pixel stride = the input's channel count) and the weights come from the
// head's softmax in planar (N, k*k, H, W) form, seen as an (N, H, W, k*k)
// view: passing strides takes both as they are, with no copy, and makes
// the weight reads of neighbouring threads (neighbouring x) coalesced.
// The output is written contiguous NHWC (N, H, W, C).
//
// One thread per output pixel in a 32x8 block; C <= 4 channels.

#include <cuda_runtime.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;
constexpr int MAXC = 4;

template <int K>
__global__ void __launch_bounds__(BW * BH)
kpn_apply_kernel(const float* __restrict__ noisy, const float* __restrict__ weights,
                 float* __restrict__ out, int h, int w, int c,
                 long long nsn, long long nsy, long long nsx, long long nsc,
                 long long wsn, long long wst, long long wsy, long long wsx) {
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
  extern __shared__ float tile[];  // planar [c][TH][TW]

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const float* src = noisy + n * nsn;

  // Stage the halo'd tile; channel fastest so a pixel's channels are read
  // together.
  const int tile_elems = TH * TW * c;
  for (int i = threadIdx.y * BW + threadIdx.x; i < tile_elems; i += BW * BH) {
    const int ch = i % c;
    const int px = i / c;
    const int tx = px % TW;
    const int ty = px / TW;
    const int gy = y0 + ty - P;
    const int gx = x0 + tx - P;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = src[gy * nsy + gx * nsx + ch * nsc];
    }
    tile[(ch * TH + ty) * TW + tx] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  const float* wp = weights + n * wsn + y * wsy + x * wsx;
  float acc[MAXC];
#pragma unroll
  for (int ch = 0; ch < MAXC; ++ch) acc[ch] = 0.0f;

#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const int dy = t / K;
    const int dx = t % K;
    const float wt = __ldg(wp + t * wst);
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      if (ch < c) {
        acc[ch] = fmaf(wt, tile[(ch * TH + threadIdx.y + dy) * TW + threadIdx.x + dx], acc[ch]);
      }
    }
  }

  float* op = out + ((static_cast<long long>(n) * h + y) * w + x) * c;
#pragma unroll
  for (int ch = 0; ch < MAXC; ++ch) {
    if (ch < c) op[ch] = acc[ch];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched). The caller checks shapes, k and c; k other than 3 or 5
// and c outside 1..4 return cudaErrorInvalidValue without launching.
extern "C" int kpn_apply_f32(const float* noisy, const float* weights, float* out,
                             int n, int h, int w, int c, int k,
                             long long nsn, long long nsy, long long nsx, long long nsc,
                             long long wsn, long long wst, long long wsy, long long wsx,
                             void* stream) {
  if (c < 1 || c > MAXC || n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BW, BH);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n);
  const size_t smem = static_cast<size_t>(BH + k - 1) * (BW + k - 1) * c * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3) {
    kpn_apply_kernel<3><<<grid, block, smem, s>>>(noisy, weights, out, h, w, c,
                                                  nsn, nsy, nsx, nsc, wsn, wst, wsy, wsx);
  } else if (k == 5) {
    kpn_apply_kernel<5><<<grid, block, smem, s>>>(noisy, weights, out, h, w, c,
                                                  nsn, nsy, nsx, nsc, wsn, wst, wsy, wsx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
