// Kernel-prediction filter apply for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel deepdenoiser_tpu/ops/kpn_pallas.py::_kernel
// (launched by _apply_planes, public apply_per_pixel_kernels_pallas):
//
//   out[n,y,x,c] = sum_{t<k*k} w[n,y,x,t] * noisy[n, y+t/k-p, x+t%k-p, c]
//
// zero outside the frame, p = k/2, k in {3, 5}, C in 1..4, taps summed in
// fp32 in the order t = 0..k*k-1 as the plain version (models/kpn.py) does.
//
// What bounds it: memory. Per pixel it reads C + k*k floats and writes C;
// at k=5, C=3 that is 124 useful bytes against 150 FLOP (1.2 FLOP/B, far
// below the card's ~20 FLOP/B fp32 balance point). At the paths' shapes
// the useful bytes, at 3.35 TB/s, are:
//
//   joint 1080p plane (1, 1144, 1984, 3)   281.4 MB   84.0 us
//   group plane       (4, 1144, 1984, 3)  1125.8 MB  336.1 us
//   4K tile batch     (8, 656, 656, 3)     426.9 MB  127.4 us
//   train batch       (16, 96, 96, 3)       18.3 MB    5.5 us
//
// The launches move more. The weights are the head's softmax output, an
// (N, H, W, k*k) tensor with the taps contiguous: 100 B a pixel, read
// whole. The noisy signal is a slot view: channels 3s..3s+2 of the joint
// model's 24-channel signal (12 B at a 96 B pixel stride), or of x[..., :6]
// of group mode's 14-channel input (12 B at a 56 B stride). Its 12 B lie
// in one 32 B sector of the pixel, two for joint slots 2 and 5, and the
// card fetches such scattered reads as 64 B blocks (the stride timings in
// csrc/kpn_apply_bwd.cu): 32-64 + 100 + 12 = 144-176 B a pixel moved,
// 1.16-1.42x the useful bytes.
//
// The design, against that bound:
//   - A block runs 128 threads (4 warps) over a tile 32 pixels wide (BW:
//     one warp across x, so every shared-memory read below is
//     conflict-free) and BH rows. A launch of more 32x8 tiles than one wave
//     of the device holds (every frame path) takes 32x8 tiles, each thread
//     QY = 2 vertically neighbouring pixels: it reads each window row its
//     two pixels share once (6 instead of 10 at k=5) and the window's halo
//     is 1.5x the tile, not 2x. A launch that fits in one wave (the
//     training batch: 576 such tiles, 792 resident on 132 SMs) takes 32x4
//     tiles, a pixel a thread: twice the blocks, 8-9 an SM instead of 4-5,
//     and a shorter tail; there every block runs at once, so its time is
//     the last block's loads, compute and stores (tile_rows() decides).
//   - C, k and BH are template parameters: every divisor of the staging
//     and compute loops is a compile-time constant.
//   - Staging, all of it issued before the first wait (cp.async, one
//     commit group): the weight tile is BH rows of up to BW*k*k contiguous
//     floats (3200 B at k=5), copied in 16 B cp.async.cg copies with an L2
//     prefetch of the whole 128 B line. A row
//     whose start is not 16 B aligned (w*k*k not a multiple of 4) lands in
//     shared memory shifted by its misalignment, so its body still goes in
//     16 B copies; at most 3 floats at each end take 4 B copies. The halo'd
//     (BH+k-1) x (BW+k-1) x C noisy window goes in 4 B copies read through
//     the slot view's strides, zero-filled outside the frame, so no padded
//     copy of the plane is ever made; neighbouring tiles' halos are L2 hits.
//   - Compute reads tap t of lane x's pixel at word x*k*k + t of its
//     weight row: an odd stride (25 or 9) across the warp, no bank
//     conflicts; the window is planar per channel, lanes on neighbouring
//     words.
//   - The tile's (BH, BW, C) result goes through shared memory and out in
//     one pass of 16 B stores of each row's contiguous min(BW, w-x0)*C
//     floats (shifted as the weight rows are when the row start is not
//     16 B aligned), not C scalar stores a pixel at a 12 B stride.
//
// Any element strides are taken (the tests and the backward pass other
// layouts): weights whose taps are not contiguous, or whose pixels are not
// k*k floats apart, are staged element by element through their strides,
// so a planar (N, k*k, H, W) view still works, at a cost. The output is
// written contiguous NHWC (N, H, W, C).
//
// k = 21 (the KPCN's head) takes a form of its own, kpn_apply_kernel_warp.
// Its weight rows do not fit the staging above (a 32-pixel row is 441 x 32
// floats, 56 KB), and a pixel's 441 weights, 1764 B, are more than a
// thread should hold. So a warp takes a pixel: lane l reads taps l, l + 32,
// ... of the pixel's contiguous weights (14 loads, all in flight before
// the first is used; each warp instruction reads 128 contiguous bytes), and
// multiplies each by the signal at its tap from shared memory; the lanes'
// sums meet in an xor butterfly of shuffles, C of them, and lanes 0..C-1
// store the pixel's channels. A block of 8 warps takes a 32 x 8 tile, a
// warp a row of it, pixel after pixel, so a warp's loads run along one
// contiguous 56 KB stretch of the weights; the tile's halo'd signal window,
// 28 x 52 x C floats, is staged once by stage() above with a row pitch of
// 53: 53 = 21 (mod 32), so tap t of a row lies at bank t + const (mod 32),
// and a warp's 32 consecutive taps hit 32 banks. Each weight is read once
// and the weights are 99 % of the bytes (1764 of 1776 a pixel): at the
// KPCN's 1080p plane, (4, 1136, 1976), a slot's weights are 15.8 GB and
// 3.96e9 elements, so every offset is 64-bit. The sum of a pixel's taps is
// each lane's taps in order, then the butterfly: not the plain version's
// order, so it agrees with it to rounding, not bit for bit. It has no
// backward kernel (ops/kpn_apply.py refuses k = 21 there).

#include <cuda_runtime.h>

#include <atomic>

#include "kpn_stage.cuh"

namespace {

using kpn::cp_async16;
using kpn::cp_async4;
using kpn::cp_async_commit;
using kpn::cp_async_wait;
using kpn::dispatch;
using kpn::misalignment;
using kpn::stage;

constexpr int BW = 32;   // tile width, pixels: one warp across x
constexpr int NT = 128;  // threads a block; a thread owns BH / 4 rows of a column

template <int K, int C, int BH>
__global__ void __launch_bounds__(NT)
kpn_apply_kernel(const float* __restrict__ noisy, const float* __restrict__ weights,
                 float* __restrict__ out, int h, int w,
                 long long nsn, long long nsy, long long nsx, long long nsc,
                 long long wsn, long long wst, long long wsy, long long wsx) {
  constexpr int QY = BW * BH / NT;  // vertically neighbouring pixels a thread
  constexpr int K2 = K * K;
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
  constexpr int WROW = BW * K2 + 4;  // a weight row and up to 3 floats of shift
  constexpr int OROW = BW * C + 4;   // an output row and up to 3 floats of shift
  __shared__ __align__(16) float ws[BH * WROW];
  __shared__ __align__(16) float win[C * TH * TW];
  __shared__ __align__(16) float os[BH * OROW];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;
  const int cols = min(BW, w - x0);
  // the tile's weight rows are contiguous runs of cols*K2 floats
  const bool runs = wst == 1 && wsx == K2;
  const float* wtile = weights + n * wsn + x0 * wsx;
  float* otile = out + (static_cast<long long>(n) * h * w + x0) * C;

  stage<C, NT, TH, TW, TW>(win, noisy + n * nsn, tid, y0 - P, x0 - P, h, w, nsy, nsx, nsc);
  if (runs) {
    const int nel = cols * K2;
    for (int r = 0; r < BH && y0 + r < h; ++r) {
      const float* g = wtile + (y0 + r) * wsy;
      const int mis = misalignment(g);
      const int head = min((4 - mis) & 3, nel);
      const int quads = (nel - head) / 4;
      const int tail = head + 4 * quads;
      float* s = ws + r * WROW + mis;  // s[e] is 16 B aligned where g[e] is
      for (int q = tid; q < quads; q += NT) cp_async16(s + head + 4 * q, g + head + 4 * q);
      if (tid < head) cp_async4(s + tid, g + tid, true);
      if (tid >= 4 && tail + tid - 4 < nel) {
        cp_async4(s + tail + tid - 4, g + tail + tid - 4, true);
      }
    }
  } else {
    for (int i = tid; i < BH * BW * K2; i += NT) {
      const int r = i / (BW * K2);
      const int e = i - r * (BW * K2);
      const int px = e / K2;
      const int t = e - px * K2;
      if (y0 + r < h && px < cols) {
        cp_async4(ws + r * WROW + e, wtile + (y0 + r) * wsy + px * wsx + t * wst, true);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = tid % BW;
  const int ry0 = tid / BW * QY;
  const float* wp[QY];
#pragma unroll
  for (int j = 0; j < QY; ++j) {
    const int shift = runs ? misalignment(wtile + (y0 + ry0 + j) * wsy) : 0;
    wp[j] = ws + (ry0 + j) * WROW + shift + lane * K2;
  }
  float acc[QY][C];
#pragma unroll
  for (int j = 0; j < QY; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;
  }
  // Window row r feeds output row j at dy = r - j: for each output row the
  // taps arrive in the order t = dy*K + dx = 0..K2-1.
#pragma unroll
  for (int r = 0; r < QY + K - 1; ++r) {
    float v[C][K];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) v[c][dx] = win[(c * TH + ry0 + r) * TW + lane + dx];
    }
#pragma unroll
    for (int j = 0; j < QY; ++j) {
      const int dy = r - j;
      if (dy < 0 || dy >= K) continue;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float wt = wp[j][dy * K + dx];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] = fmaf(wt, v[c][dx], acc[j][c]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QY; ++j) {
    const int y = y0 + ry0 + j;
    if (y >= h) continue;
    float* o = os + (ry0 + j) * OROW + misalignment(otile + static_cast<long long>(y) * w * C) +
               lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[j][c];
  }
  __syncthreads();

  // One pass over the tile's rows: QPR 16 B stores a row (one fewer, and
  // up to 3 + 3 scalar ones, where the row start is not 16 B aligned).
  constexpr int QPR = BW * C / 4;
  const int nel = cols * C;
  for (int i = tid; i < BH * (QPR + 8); i += NT) {
    const int r = i / (QPR + 8);
    const int q = i - r * (QPR + 8);
    if (y0 + r >= h) break;
    float* g = otile + static_cast<long long>(y0 + r) * w * C;
    const int mis = misalignment(g);
    const int head = min((4 - mis) & 3, nel);
    const int quads = (nel - head) / 4;
    const float* s = os + r * OROW + mis;
    if (q < quads) {
      *reinterpret_cast<float4*>(g + head + 4 * q) =
          *reinterpret_cast<const float4*>(s + head + 4 * q);
    } else if (q >= QPR) {  // scalars: head elements 0..2, tail elements 4..6
      const int e = q - QPR;
      const int at = e < 4 ? e : head + 4 * quads + e - 4;
      if ((e < 4 ? e < head : at < nel)) g[at] = s[at];
    }
  }
}

// Tile rows of a launch: 8, unless all its 32x8 tiles fit in one wave of
// the device (blocks resident per SM x SMs), then 4. The wave is queried
// once per device and (K, C); later launches only compare counts.
template <int K, int C>
int tile_rows(int n, int h, int w) {
  constexpr int kDevices = 64;
  static std::atomic<long long> waves[kDevices];  // 0 until queried
  int dev = 0;
  cudaGetDevice(&dev);
  long long wave = dev < kDevices ? waves[dev].load(std::memory_order_relaxed) : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kpn_apply_kernel<K, C, 8>, NT, 0);
    wave = static_cast<long long>(sms) * per_sm;
    if (dev < kDevices) waves[dev].store(wave, std::memory_order_relaxed);
  }
  const long long tiles = static_cast<long long>(n) * ((h + 7) / 8) * ((w + BW - 1) / BW);
  return tiles > wave ? 8 : 4;
}

template <int K, int C, int BH>
cudaError_t launch_rows(const float* noisy, const float* weights, float* out, int n, int h,
                        int w, const long long* s, cudaStream_t stream) {
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n);
  kpn_apply_kernel<K, C, BH><<<grid, NT, 0, stream>>>(noisy, weights, out, h, w, s[0], s[1],
                                                      s[2], s[3], s[4], s[5], s[6], s[7]);
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t launch(const float* noisy, const float* weights, float* out, int n, int h, int w,
                   const long long* s, cudaStream_t stream) {
  if (tile_rows<K, C>(n, h, w) == 8) {
    return launch_rows<K, C, 8>(noisy, weights, out, n, h, w, s, stream);
  }
  return launch_rows<K, C, 4>(noisy, weights, out, n, h, w, s, stream);
}

constexpr int WK = 21;                  // the warp form's kernel size
constexpr int WK2 = WK * WK;
constexpr int WP = WK / 2;
constexpr int WBH = 8;                  // tile rows: a warp a row
constexpr int WNT = 32 * WBH;           // threads a block
constexpr int WTH = WBH + WK - 1;       // window rows, 28
constexpr int WTW = BW + WK - 1;        // window columns, 52
constexpr int WROWP = WTW + 1;          // window row pitch, 53 = 21 (mod 32)
constexpr int WJ = (WK2 + 31) / 32;     // taps a lane, 14

template <int C>
__global__ void __launch_bounds__(WNT)
kpn_apply_kernel_warp(const float* __restrict__ noisy, const float* __restrict__ weights,
                      float* __restrict__ out, int h, int w,
                      long long nsn, long long nsy, long long nsx, long long nsc,
                      long long wsn, long long wst, long long wsy, long long wsx) {
  __shared__ __align__(16) float win[C * WTH * WROWP];
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * WBH;
  const int tid = threadIdx.x;
  stage<C, WNT, WTH, WTW, WROWP>(win, noisy + n * nsn, tid, y0 - WP, x0 - WP, h, w, nsy, nsx,
                                 nsc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = tid & 31;
  const int ry = tid >> 5;  // this warp's tile row
  const int y = y0 + ry;
  if (y >= h) return;
  // tap t = lane + 32j sits at window offset (ry + t/K)*pitch + t%K + column
  int at[WJ];
#pragma unroll
  for (int j = 0; j < WJ; ++j) {
    const int t = lane + 32 * j;
    at[j] = t < WK2 ? (ry + t / WK) * WROWP + t % WK : -1;
  }
  const float* wrow = weights + n * wsn + y * wsy + x0 * wsx;
  float* orow = out + ((static_cast<long long>(n) * h + y) * w + x0) * C;
  const int cols = min(BW, w - x0);
  for (int px = 0; px < cols; ++px) {
    const float* wp = wrow + px * wsx;
    float wt[WJ];
#pragma unroll
    for (int j = 0; j < WJ; ++j) wt[j] = at[j] >= 0 ? __ldg(wp + (lane + 32 * j) * wst) : 0.0f;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < WJ; ++j) {
      if (at[j] < 0) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(wt[j], win[c * WTH * WROWP + at[j] + px], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (lane == c) orow[px * C + c] = acc[c];
    }
  }
}

template <int C>
cudaError_t launch_warp(const float* noisy, const float* weights, float* out, int n, int h, int w,
                        const long long* s, cudaStream_t stream) {
  const dim3 grid((w + BW - 1) / BW, (h + WBH - 1) / WBH, n);
  kpn_apply_kernel_warp<C><<<grid, WNT, 0, stream>>>(noisy, weights, out, h, w, s[0], s[1], s[2],
                                                     s[3], s[4], s[5], s[6], s[7]);
  return cudaGetLastError();
}

// Calls f(Int<C>) for runtime c in 1..4; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t dispatch_c(int c, F&& f) {
  switch (c) {
    case 1: return f(kpn::Int<1>{});
    case 2: return f(kpn::Int<2>{});
    case 3: return f(kpn::Int<3>{});
    case 4: return f(kpn::Int<4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched), its tiles chosen by tile_rows() (k = 21: the warp form).
// The caller checks shapes, k and c; k other than 3, 5 or 21 and c outside
// 1..4 return cudaErrorInvalidValue without launching.
extern "C" int kpn_apply_f32(const float* noisy, const float* weights, float* out,
                             int n, int h, int w, int c, int k,
                             long long nsn, long long nsy, long long nsx, long long nsc,
                             long long wsn, long long wst, long long wsy, long long wsx,
                             void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[8] = {nsn, nsy, nsx, nsc, wsn, wst, wsy, wsx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == WK) {
    return static_cast<int>(dispatch_c(c, [&](auto cc) {
      return launch_warp<decltype(cc)::value>(noisy, weights, out, n, h, w, s, st);
    }));
  }
  return static_cast<int>(dispatch(k, c, [&](auto kk, auto cc) {
    return launch<decltype(kk)::value, decltype(cc)::value>(noisy, weights, out, n, h, w, s, st);
  }));
}

// The tile rows (8 or 4) a launch of k, c over (n, h, w) takes (k = 21:
// the warp form's 8); a negative cudaError_t for k or c out of range.
extern "C" int kpn_apply_tile_rows(int n, int h, int w, int c, int k) {
  if (k == WK) return c >= 1 && c <= 4 ? WBH : -static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;
  const cudaError_t err = dispatch(k, c, [&](auto kk, auto cc) {
    rows = tile_rows<decltype(kk)::value, decltype(cc)::value>(n, h, w);
    return cudaSuccess;
  });
  return err == cudaSuccess ? rows : -static_cast<int>(err);
}

// Resident blocks per SM of the kernel for k, c and tile rows (8 or 4; k =
// 21: the warp form, rows 8), from the occupancy API; a negative
// cudaError_t on failure.
extern "C" int kpn_apply_resident_blocks(int k, int c, int rows) {
  if (rows != 8 && rows != 4) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  if (k == WK) {
    if (rows != WBH) return -static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = dispatch_c(c, [&](auto cc) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kpn_apply_kernel_warp<decltype(cc)::value>, WNT, 0);
    });
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  }
  const cudaError_t err = dispatch(k, c, [&](auto kk, auto cc) {
    constexpr int K = decltype(kk)::value, C = decltype(cc)::value;
    return rows == 8
               ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kpn_apply_kernel<K, C, 8>,
                                                               NT, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kpn_apply_kernel<K, C, 4>,
                                                               NT, 0);
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
