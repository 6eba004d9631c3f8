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
// What bounds them: memory. Per pixel the weight gradient reads C noisy and
// C gradient floats and writes k*k; the signal gradient reads C gradient
// and k*k weight floats and writes C. At k=5, C=3 each needs 124 B against
// 150 FLOP, far below the card's fp32 balance point. Those are the useful
// bytes, the bound. A launch of the kpn-hq train step moves more: slot s
// is channels 3s..3s+2 of the joint model's 24-channel signal (the
// torch.cat of the four signal runs) and g the same channels of the head
// output's gradient, 12 B read at a 96 B pixel stride. That is one 32 B
// sector of each pixel (two for slots 2 and 5), and the card fetches such
// scattered reads as 64 B blocks: the stride probe of chip_smoke.py's
// phase 16 times d_w at slot 0 of 8-, 16- and 24-channel stacks, and the
// 16-channel one (the 8-channel one's 32 B sectors, but a 64 B block a
// pixel instead of half of one) reads a third slower than the 8-channel
// one, near the 24-channel one (NVIDIA H100 80GB HBM3, 700 W). So d_w
// moves 64 + 64 + 100 = 228 B a pixel at slot 0 (33.6 MB, 10.0 us at
// 3.35 TB/s at the training batch (16, 96, 96)) and 292 B at slots 2 and
// 5; d_noisy 64 + 100 + 12 = 176 B. No per-slot kernel can move less.
//
// Both kernels take every input with element strides (noisy and g as those
// slot views, w as the head's (N, H, W, k*k) softmax), so nothing is
// copied before a launch. The cp.async helpers, the window staging and the
// dispatch of k and c live in kpn_stage.cuh, shared with the forward.
// C (1..4) and k (3, 5) are template parameters, so staging has
// compile-time divisors. Staging copies with cp.async (4 bytes,
// zero-filled outside the frame), all of a block's
// copies issued before the first is waited for; a row of the window is
// walked pixel-major, channel-minor, so one warp instruction reads the
// channels of about 11 neighbouring pixels (a few cache lines at a 96 B
// stride), and a thread's offsets within a row are the same in every row.
// Every tile launches its own block: a block that walked several tiles,
// prefetching the next tile's window while it stored the current one,
// measured slower at the training batch and at the 1080p plane; the
// resident blocks overlap one block's loads with another's stores.
//
//   kpn_apply_bwd_weights_f32 (d_w). A block of 64 threads owns a 32x8
//     tile; each thread 4 neighbouring x of one row. The block stages the
//     tile's halo'd noisy window and its g values; each thread then writes,
//     per tap, its 4 dot products over channels (summed in channel order)
//     as one 16-byte store into the planar (N, k*k, H, W) result; a ragged
//     edge or a width that is not a multiple of 4 takes scalar stores. The
//     wrapper returns the (N, H, W, k*k) permuted view; the backward of
//     the head's softmax over the last axis makes it contiguous, one
//     transposing copy a slot. No streaming hint on the stores: that copy
//     reads d_w next, from L2 where it can. 20 blocks are resident per SM
//     at k=5, C=3 (48 registers; NVIDIA H100 80GB HBM3), so the
//     training batch's 576 blocks are all resident at once, 4-5 to an SM.
//     Capping the registers to hold more blocks measured slower.
//
//   kpn_apply_bwd_noisy_f32 (d_noisy), the gather form of the transpose: a
//     thread per input pixel in a 32x4 block reads the k*k tap-flipped
//     neighbours of g*w_t. The block stages its halo'd g window; meanwhile
//     each thread issues all k*k weight loads, each predicated to 0 outside
//     the frame rather than skipped by a branch, so all are in flight
//     before the first multiply. Taps are summed in the order t =
//     0..k*k-1, as the plain version does; no atomics, so the result is
//     bitwise the same on every run. The block's (4, 32, C) output goes
//     through shared memory and out as contiguous 16-byte stores where W*C
//     is a multiple of 4, not C scalars a pixel at a 12 B stride. The
//     launch bounds ask for 10 resident blocks per SM (48 registers), so
//     the training batch's 1152 blocks are all resident at once; 32x4
//     tiles measured faster there than 32x8 and 32x2 ones, and loading
//     each weight once faster than staging the weight planes' rows in
//     16-byte copies.
//
// kpn_apply_bwd_resident_blocks reports each kernel's resident blocks per
// SM (the occupancy API); chip_smoke.py prints them beside the times.

#include <cuda_runtime.h>

#include "kpn_stage.cuh"

namespace {

using kpn::cp_async_commit;
using kpn::cp_async_wait;
using kpn::dispatch;
using kpn::stage;

constexpr int BW = 32;                       // tile width, pixels
constexpr int DW_BH = 8;                     // d_w: tile height
constexpr int QX = 4;                        // d_w: neighbouring x a thread (one 16 B store)
constexpr int DW_THREADS = BW / QX * DW_BH;  // 64
constexpr int DN_BH = 4;                     // d_noisy: tile height
constexpr int DN_THREADS = BW * DN_BH;       // 128
constexpr int DN_MIN_BLOCKS = 10;            // d_noisy: resident blocks its launch bounds ask for

// ---------------------------------------------------------------- d_w ----

template <int K, int C>
__global__ void __launch_bounds__(DW_THREADS)
kpn_bwd_weights_kernel(const float* __restrict__ noisy, const float* __restrict__ g,
                       float* __restrict__ dw, int h, int w,
                       long long nsn, long long nsy, long long nsx, long long nsc,
                       long long gsn, long long gsy, long long gsx, long long gsc) {
  constexpr int P = K / 2;
  constexpr int TH = DW_BH + K - 1;
  constexpr int ROW = (BW + K - 1 + 3) / 4 * 4;  // padded: 16 B aligned rows
  __shared__ __align__(16) float win[C * TH * ROW];    // halo'd noisy window
  __shared__ __align__(16) float gs[C * DW_BH * BW];  // the tile's g values

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * DW_BH;
  const int tid = threadIdx.x;
  stage<C, DW_THREADS, TH, BW + K - 1, ROW>(win, noisy + n * nsn, tid, y0 - P, x0 - P, h, w,
                                            nsy, nsx, nsc);
  stage<C, DW_THREADS, DW_BH, BW, BW>(gs, g + n * gsn, tid, y0, x0, h, w, gsy, gsx, gsc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int qx = tid % (BW / QX);
  const int ry = tid / (BW / QX);
  const int y = y0 + ry;
  const int x = x0 + qx * QX;
  if (y >= h || x >= w) return;

  float gv[QX][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 q = *reinterpret_cast<const float4*>(gs + (c * DW_BH + ry) * BW + qx * QX);
    gv[0][c] = q.x;
    gv[1][c] = q.y;
    gv[2][c] = q.z;
    gv[3][c] = q.w;
  }
  const long long plane = static_cast<long long>(h) * w;
  float* out = dw + static_cast<long long>(n) * (K * K) * plane + static_cast<long long>(y) * w + x;
  // every row of a tap plane starts 16 B aligned when W % 4 == 0
  const bool full = (w % QX) == 0 && x + QX <= w;

#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    // this thread's window row: columns qx*4 .. qx*4+7 of the tile
    float nv[C][8];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* rp = win + (c * TH + ry + dy) * ROW + qx * QX;
      const float4 lo = *reinterpret_cast<const float4*>(rp);
      const float4 hi = *reinterpret_cast<const float4*>(rp + 4);
      nv[c][0] = lo.x; nv[c][1] = lo.y; nv[c][2] = lo.z; nv[c][3] = lo.w;
      nv[c][4] = hi.x; nv[c][5] = hi.y; nv[c][6] = hi.z; nv[c][7] = hi.w;
    }
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float acc[QX];
#pragma unroll
      for (int j = 0; j < QX; ++j) {
        acc[j] = gv[j][0] * nv[0][j + dx];
#pragma unroll
        for (int c = 1; c < C; ++c) acc[j] = fmaf(gv[j][c], nv[c][j + dx], acc[j]);
      }
      float* op = out + (dy * K + dx) * plane;
      if (full) {
        *reinterpret_cast<float4*>(op) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < QX; ++j) {
          if (x + j < w) op[j] = acc[j];
        }
      }
    }
  }
}

// ------------------------------------------------------------ d_noisy ----

template <int K, int C>
__global__ void __launch_bounds__(DN_THREADS, DN_MIN_BLOCKS)
kpn_bwd_noisy_kernel(const float* __restrict__ g, const float* __restrict__ weights,
                     float* __restrict__ dn, int h, int w,
                     long long gsn, long long gsy, long long gsx, long long gsc,
                     long long wsn, long long wst, long long wsy, long long wsx) {
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = DN_BH + K - 1;
  __shared__ __align__(16) float tile[C * TH * TW];
  __shared__ __align__(16) float outs[DN_BH * BW * C];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * DN_BH;
  const int tid = threadIdx.y * BW + threadIdx.x;
  stage<C, DN_THREADS, TH, TW, TW>(tile, g + n * gsn, tid, y0 - P, x0 - P, h, w, gsy, gsx, gsc);
  cp_async_commit();

  // All k*k weight loads in flight before the first multiply: tap t of the
  // output pixel (u+p-dy, v+p-dx) read (u, v); 0 outside the frame.
  const int v = x0 + threadIdx.x;
  const int u = y0 + threadIdx.y;
  const float* wn = weights + n * wsn;
  float wt[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const int y = u + P - t / K;
    const int x = v + P - t % K;
    const bool in = u < h && v < w && y >= 0 && y < h && x >= 0 && x < w;
    wt[t] = in ? __ldg(wn + y * wsy + x * wsx + t * wst) : 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const float* tp = tile + (threadIdx.y + K - 1 - t / K) * TW + threadIdx.x + K - 1 - t % K;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(tp[c * TH * TW], wt[t], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) outs[(threadIdx.y * BW + threadIdx.x) * C + c] = acc[c];
  __syncthreads();

  // Each tile row's pixels are min(BW, w - x0) * C contiguous floats of the
  // (N, H, W, C) result.
  const int row_elems = min(BW, w - x0) * C;
  const bool vec = (static_cast<long long>(w) * C) % 4 == 0;  // rows start 16 B aligned
  const int quads = row_elems / 4;
  if (vec) {
    for (int i = tid; i < DN_BH * quads; i += DN_THREADS) {
      const int ry = i / quads;
      const int q = i - ry * quads;
      if (y0 + ry >= h) continue;
      float* row = dn + ((static_cast<long long>(n) * h + y0 + ry) * w + x0) * C;
      *reinterpret_cast<float4*>(row + 4 * q) =
          *reinterpret_cast<const float4*>(outs + ry * BW * C + 4 * q);
    }
  }
  const int done = vec ? 4 * quads : 0;
  const int rest = row_elems - done;
  for (int i = tid; i < DN_BH * rest; i += DN_THREADS) {
    const int ry = i / rest;
    const int e = done + i - ry * rest;
    if (y0 + ry >= h) continue;
    dn[((static_cast<long long>(n) * h + y0 + ry) * w + x0) * C + e] = outs[ry * BW * C + e];
  }
}

// ------------------------------------------------------------ dispatch ----

template <int K, int C>
cudaError_t launch_weights(const float* noisy, const float* g, float* dw, int n, int h, int w,
                           const long long* s, cudaStream_t stream) {
  const dim3 grid((w + BW - 1) / BW, (h + DW_BH - 1) / DW_BH, n);
  kpn_bwd_weights_kernel<K, C><<<grid, DW_THREADS, 0, stream>>>(
      noisy, g, dw, h, w, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t launch_noisy(const float* g, const float* weights, float* dn, int n, int h, int w,
                         const long long* s, cudaStream_t stream) {
  const dim3 grid((w + BW - 1) / BW, (h + DN_BH - 1) / DN_BH, n);
  kpn_bwd_noisy_kernel<K, C><<<grid, dim3(BW, DN_BH), 0, stream>>>(
      g, weights, dn, h, w, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t resident(int which, int* blocks) {
  return which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, kpn_bwd_weights_kernel<K, C>, DW_THREADS, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, kpn_bwd_noisy_kernel<K, C>, DN_THREADS, 0);
}

}  // namespace

// Both kernels launch on `stream` and return cudaGetLastError() after the
// launch (0 = launched). The caller checks shapes, k and c; k other than 3
// or 5 and c outside 1..4 return cudaErrorInvalidValue without launching.

// d_w, planar (N, k*k, H, W) contiguous.
extern "C" int kpn_apply_bwd_weights_f32(const float* noisy, const float* g, float* dw,
                                         int n, int h, int w, int c, int k,
                                         long long nsn, long long nsy, long long nsx, long long nsc,
                                         long long gsn, long long gsy, long long gsx, long long gsc,
                                         void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[8] = {nsn, nsy, nsx, nsc, gsn, gsy, gsx, gsc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(k, c, [&](auto kk, auto cc) {
    return launch_weights<decltype(kk)::value, decltype(cc)::value>(noisy, g, dw, n, h, w, s, st);
  }));
}

// d_noisy, (N, H, W, C) contiguous.
extern "C" int kpn_apply_bwd_noisy_f32(const float* g, const float* weights, float* dn,
                                       int n, int h, int w, int c, int k,
                                       long long gsn, long long gsy, long long gsx, long long gsc,
                                       long long wsn, long long wst, long long wsy, long long wsx,
                                       void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[8] = {gsn, gsy, gsx, gsc, wsn, wst, wsy, wsx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(k, c, [&](auto kk, auto cc) {
    return launch_noisy<decltype(kk)::value, decltype(cc)::value>(g, weights, dn, n, h, w, s, st);
  }));
}

// Resident blocks per SM of the d_w (which = 0) or d_noisy (1) kernel for
// k and c, from the occupancy API; a negative cudaError_t on failure.
extern "C" int kpn_apply_bwd_resident_blocks(int which, int k, int c) {
  if (which != 0 && which != 1) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = dispatch(k, c, [&](auto kk, auto cc) {
    return resident<decltype(kk)::value, decltype(cc)::value>(which, &blocks);
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
