// Backward of the kernel-prediction filter apply for Hopper (sm_90a), fp32.
//
// Replaces the backward of the TPU kernel's custom_vjp,
// deepdenoiser_tpu/ops/kpn_pallas.py::_kpn_pallas_bwd (lines 158-184, plain
// XLA there: k*k padded copies of g*w_t and of the noisy plane, and a
// stack). For the forward
//
//   out[n,y,x,c] = sum_t w[n,y,x,t] * noisy[n, y+dy-p, x+dx-p, c]
//
// (t = dy*k + dx, p = k/2, zero outside the frame) the two gradients are
//
//   d_w[n,y,x,t]     = sum_c g[n,y,x,c] * noisy[n, y+dy-p, x+dx-p, c]
//   d_noisy[n,u,v,c] = sum_t g[n, u+p-dy, v+p-dx, c] * w[n, u+p-dy, v+p-dx, t]
//
// Two entry points, each one launch:
//
//   kpn_apply_bwd_weights_f32  one thread per pixel in a 32x8 block. The
//     block stages its halo'd noisy tile in shared memory, zero-filled
//     outside the frame (the forward's staging loop); each thread reads its
//     C gradient values once and writes k*k dot products over channels,
//     summed in channel order. d_w is written planar (N, k*k, H, W), so
//     neighbouring threads' stores are neighbouring addresses; the wrapper
//     returns its (N, H, W, k*k) permuted view, the layout the head's
//     softmax hands to the forward, whose backward takes it without a copy.
//
//   kpn_apply_bwd_noisy_f32  the gather form of the transpose: one thread
//     per input pixel reads the k*k tap-flipped neighbours of g*w_t. The
//     block stages its halo'd g tile in shared memory (zero outside the
//     frame) and reads w directly: each w element is used once. No
//     atomics, so the result is bitwise the same on every run. Taps are
//     summed in the order t = 0..k*k-1, as the plain version does.
//
// What bounds them: memory. Per pixel the weight gradient reads C noisy and
// C gradient floats and writes k*k; the signal gradient reads C gradient
// and k*k weight floats and writes C. At k=5, C=3 each moves 124 B against
// 150 FLOP, far below the card's fp32 balance point, as the forward does.
//
// Every input is taken with element strides (the noisy signal is a
// 3-channel slice of the model's fp32 NHWC input, g a channel range of the
// head's concatenated output gradient, w a permuted planar view), so
// nothing is copied before a launch. C <= 4.

#include <cuda_runtime.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;
constexpr int MAXC = 4;

// Stage the (BH+K-1) x (BW+K-1) x c tile whose top-left frame pixel is
// (y0 - P, x0 - P), planar [c][TH][TW], zero outside the frame.
template <int K>
__device__ __forceinline__ void stage_tile(float* tile, const float* src, int y0, int x0, int h,
                                           int w, int c, long long sy, long long sx,
                                           long long sc) {
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
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
      v = src[gy * sy + gx * sx + ch * sc];
    }
    tile[(ch * TH + ty) * TW + tx] = v;
  }
}

template <int K>
__global__ void __launch_bounds__(BW * BH)
kpn_bwd_weights_kernel(const float* __restrict__ noisy, const float* __restrict__ g,
                       float* __restrict__ dw, int h, int w, int c,
                       long long nsn, long long nsy, long long nsx, long long nsc,
                       long long gsn, long long gsy, long long gsx, long long gsc) {
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
  extern __shared__ float tile[];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  stage_tile<K>(tile, noisy + n * nsn, y0, x0, h, w, c, nsy, nsx, nsc);
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  const float* gp = g + n * gsn + y * gsy + x * gsx;
  float gv[MAXC];
#pragma unroll
  for (int ch = 0; ch < MAXC; ++ch) gv[ch] = ch < c ? __ldg(gp + ch * gsc) : 0.0f;

  const long long plane = static_cast<long long>(h) * w;
  float* out = dw + static_cast<long long>(n) * (K * K) * plane + static_cast<long long>(y) * w + x;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const int dy = t / K;
    const int dx = t % K;
    const float* tp = tile + (threadIdx.y + dy) * TW + threadIdx.x + dx;
    float acc = gv[0] * tp[0];
#pragma unroll
    for (int ch = 1; ch < MAXC; ++ch) {
      if (ch < c) acc = fmaf(gv[ch], tp[ch * TH * TW], acc);
    }
    out[t * plane] = acc;
  }
}

template <int K>
__global__ void __launch_bounds__(BW * BH)
kpn_bwd_noisy_kernel(const float* __restrict__ g, const float* __restrict__ weights,
                     float* __restrict__ dn, int h, int w, int c,
                     long long gsn, long long gsy, long long gsx, long long gsc,
                     long long wsn, long long wst, long long wsy, long long wsx) {
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
  extern __shared__ float tile[];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  stage_tile<K>(tile, g + n * gsn, y0, x0, h, w, c, gsy, gsx, gsc);
  __syncthreads();

  const int v = x0 + threadIdx.x;
  const int u = y0 + threadIdx.y;
  if (v >= w || u >= h) return;

  const float* wn = weights + n * wsn;
  float acc[MAXC];
#pragma unroll
  for (int ch = 0; ch < MAXC; ++ch) acc[ch] = 0.0f;

#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const int dy = t / K;
    const int dx = t % K;
    // the output pixel whose tap t read (u, v)
    const int y = u + P - dy;
    const int x = v + P - dx;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const float wt = __ldg(wn + y * wsy + x * wsx + t * wst);
    const float* tp = tile + (threadIdx.y + K - 1 - dy) * TW + threadIdx.x + K - 1 - dx;
#pragma unroll
    for (int ch = 0; ch < MAXC; ++ch) {
      if (ch < c) acc[ch] = fmaf(tp[ch * TH * TW], wt, acc[ch]);
    }
  }

  float* op = dn + ((static_cast<long long>(n) * h + u) * w + v) * c;
#pragma unroll
  for (int ch = 0; ch < MAXC; ++ch) {
    if (ch < c) op[ch] = acc[ch];
  }
}

size_t tile_bytes(int k, int c) {
  return static_cast<size_t>(BH + k - 1) * (BW + k - 1) * c * sizeof(float);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = launched). The caller checks shapes, k and c; k other than 3 or 5
// and c outside 1..4 return cudaErrorInvalidValue without launching.

// d_w, planar (N, k*k, H, W) contiguous.
extern "C" int kpn_apply_bwd_weights_f32(const float* noisy, const float* g, float* dw,
                                         int n, int h, int w, int c, int k,
                                         long long nsn, long long nsy, long long nsx, long long nsc,
                                         long long gsn, long long gsy, long long gsx, long long gsc,
                                         void* stream) {
  if (c < 1 || c > MAXC || n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BW, BH);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3) {
    kpn_bwd_weights_kernel<3><<<grid, block, tile_bytes(3, c), s>>>(
        noisy, g, dw, h, w, c, nsn, nsy, nsx, nsc, gsn, gsy, gsx, gsc);
  } else if (k == 5) {
    kpn_bwd_weights_kernel<5><<<grid, block, tile_bytes(5, c), s>>>(
        noisy, g, dw, h, w, c, nsn, nsy, nsx, nsc, gsn, gsy, gsx, gsc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_noisy, (N, H, W, C) contiguous.
extern "C" int kpn_apply_bwd_noisy_f32(const float* g, const float* weights, float* dn,
                                       int n, int h, int w, int c, int k,
                                       long long gsn, long long gsy, long long gsx, long long gsc,
                                       long long wsn, long long wst, long long wsy, long long wsx,
                                       void* stream) {
  if (c < 1 || c > MAXC || n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BW, BH);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3) {
    kpn_bwd_noisy_kernel<3><<<grid, block, tile_bytes(3, c), s>>>(
        g, weights, dn, h, w, c, gsn, gsy, gsx, gsc, wsn, wst, wsy, wsx);
  } else if (k == 5) {
    kpn_bwd_noisy_kernel<5><<<grid, block, tile_bytes(5, c), s>>>(
        g, weights, dn, h, w, c, gsn, gsy, gsx, gsc, wsn, wst, wsy, wsx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
