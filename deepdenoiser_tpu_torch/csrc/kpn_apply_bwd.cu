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
// scattered reads as 64 B blocks: timed at slot 0 of 8-, 16- and
// 24-channel stacks, d_w over the 16-channel one (the 8-channel one's 32 B
// sectors, but a 64 B block a pixel instead of half of one) reads a third
// slower than over the 8-channel one, near the 24-channel one (NVIDIA H100
// 80GB HBM3, 700 W). So d_w
// moves 64 + 64 + 100 = 228 B a pixel at slot 0 (33.6 MB, 10.0 us at
// 3.35 TB/s at the training batch (16, 96, 96)) and 292 B at slots 2 and
// 5; d_noisy 64 + 100 + 12 = 176 B. No per-slot kernel can move less.
//
// Both kernels take every input with element strides (noisy and g as those
// slot views, w as the head's (N, H, W, k*k) softmax), so nothing is
// copied before a launch, and both write their result in the layout the
// head works in: d_w contiguous (N, H, W, k*k), the layout of the softmax
// whose backward takes it as it is (the JAX backward's
// jnp.stack(d_w, axis=-1)), and d_noisy contiguous (N, H, W, C). The
// cp.async helpers, the window staging and the dispatch of k and c live in
// kpn_stage.cuh, shared with the forward. C (1..4), k (3, 5) and the tile
// rows are template parameters, so staging has compile-time divisors. All
// of a block's copies are issued before the first is waited for. Every
// tile launches its own block (a block that walked several tiles measured
// slower when the layout was planar); the resident blocks overlap one
// block's loads with another's stores. A block is 32 pixels wide and a
// warp owns a tile row, a lane a pixel: the shared-memory accesses below
// walk the lanes across x at an odd stride (k*k = 25 or 9 floats a pixel,
// C = 3) or on neighbouring words, free of bank conflicts. Each warp
// writes its row's results to its own row of shared memory and stores it
// as soon as it is done, as contiguous 16 B stores (store_row: shifted
// where the row start is not 16 B aligned, at most 3 scalar stores at
// each end): no block barrier after the staging, so one warp's stores
// overlap the others' arithmetic. Held to one block barrier before its
// stores, the same d_w took 15.4 us at the training batch's slot 0
// against 12.7 for the planar kernel it replaces (NVIDIA H100 80GB HBM3,
// 700 W).
//
//   kpn_apply_bwd_weights_f32 (d_w). A block of 128 threads owns a 32x4
//     tile. It stages the tile's halo'd noisy window and its g values (4 B
//     copies through the views' strides, zero outside the frame); each
//     lane computes its pixel's k*k dot products over channels (summed in
//     channel order, so the result is bitwise that of the planar kernel)
//     into the warp's row, 3200 contiguous bytes at k=5, and the warp
//     stores it. 17.9 KB of shared memory, 10 blocks an SM, so the
//     training batch's 1152 blocks are all resident at once. 32x8 tiles
//     (5 an SM) and 32x2 tiles measured slower at the training batch; at
//     the 1080p plane 32x8 is within 1.3 %. The planar layout it replaces
//     made the head's softmax backward copy the permuted d_w contiguous:
//     a transposing copy a slot, 8 a kpn-hq train step, which are gone.
//
//   kpn_apply_bwd_noisy_f32 (d_noisy), the gather form of the transpose: a
//     lane per input pixel of a 32x4 tile reads the k*k tap-flipped
//     neighbours of g*w_t. The block stages its halo'd g window and its
//     halo'd weight window, 8 rows of 36 pixels' k*k taps (28.9 KB at
//     k=5), each row of the head's weights one contiguous run copied in
//     16 B cp.async copies (stage_taps), zero outside the frame; weights
//     in another layout (a planar view in the tests) go in 4 B copies
//     through their strides. Taps are summed in the order t = 0..k*k-1, as
//     the plain version does; no atomics, so the result is bitwise the
//     same on every run. 34 KB of shared memory hold 6 blocks an SM, so
//     the training batch's 1152 blocks run in 1.45 waves, and the window
//     reads each weight 2.25 times from L2: it measured slower than the
//     25 weight loads a thread straight from device memory that it
//     replaces. Staging only the taps each window row feeds (4 B copies,
//     10 blocks an SM) measured slower still.
//
// kpn_apply_bwd_resident_blocks reports each kernel's resident blocks per
// SM (the occupancy API); tests/test_torch_gpu.py holds the training batch
// to one wave with it.

#include <cuda_runtime.h>

#include "kpn_stage.cuh"

namespace {

using kpn::cp_async16;
using kpn::cp_async4;
using kpn::cp_async_commit;
using kpn::cp_async_wait;
using kpn::dispatch;
using kpn::misalignment;
using kpn::stage;

constexpr int BW = 32;        // tile width, pixels: one warp across x
constexpr int TILE_ROWS = 4;  // tile rows of both kernels, a warp a row

// One warp stores `nel` contiguous floats at g from the shared row s_row,
// where they start misalignment(g) floats in (so both sides of the body
// are 16 B aligned): 16 B stores, and at most 3 scalar ones at each end.
__device__ __forceinline__ void store_row(float* g, const float* s_row, int lane, int nel) {
  const int mis = misalignment(g);
  const int head = min((4 - mis) & 3, nel);
  const int quads = (nel - head) / 4;
  const int tail = head + 4 * quads;
  const float* s = s_row + mis;
  for (int q = lane; q < quads; q += BW) {
    *reinterpret_cast<float4*>(g + head + 4 * q) =
        *reinterpret_cast<const float4*>(s + head + 4 * q);
  }
  if (lane < head) g[lane] = s[lane];
  if (lane >= 4 && tail + lane - 4 < nel) g[tail + lane - 4] = s[tail + lane - 4];
}

// ---------------------------------------------------------------- d_w ----

template <int K, int C, int BH>
__global__ void __launch_bounds__(BW * BH)
kpn_bwd_weights_kernel(const float* __restrict__ noisy, const float* __restrict__ g,
                       float* __restrict__ dw, int h, int w,
                       long long nsn, long long nsy, long long nsx, long long nsc,
                       long long gsn, long long gsy, long long gsx, long long gsc) {
  constexpr int NT = BW * BH;
  constexpr int K2 = K * K;
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
  constexpr int OROW = BW * K2 + 4;  // a result row and up to 3 floats of shift
  __shared__ __align__(16) float win[C * TH * TW];  // halo'd noisy window
  __shared__ __align__(16) float gs[C * BH * BW];   // the tile's g values
  __shared__ __align__(16) float os[BH * OROW];     // the tile's d_w rows

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;
  stage<C, NT, TH, TW, TW>(win, noisy + n * nsn, tid, y0 - P, x0 - P, h, w, nsy, nsx, nsc);
  stage<C, NT, BH, BW, BW>(gs, g + n * gsn, tid, y0, x0, h, w, gsy, gsx, gsc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A warp a row, a lane a pixel: its k*k dot products go to the warp's
  // own row of os, which the warp stores as soon as it is done (no block
  // barrier: one warp's stores overlap the others' arithmetic).
  const int lane = tid % BW;
  const int ry = tid / BW;
  float gv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gv[c] = gs[(c * BH + ry) * BW + lane];
  float* grow = dw + ((static_cast<long long>(n) * h + y0 + ry) * w + x0) * K2;
  float* srow = os + ry * OROW;
  float* op = srow + misalignment(grow) + lane * K2;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    float v[C][K];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) v[c][dx] = win[(c * TH + ry + dy) * TW + lane + dx];
    }
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float acc = gv[0] * v[0][dx];
#pragma unroll
      for (int c = 1; c < C; ++c) acc = fmaf(gv[c], v[c][dx], acc);
      op[dy * K + dx] = acc;
    }
  }
  __syncwarp();
  if (y0 + ry < h) store_row(grow, srow, lane, min(BW, w - x0) * K2);
}

// ------------------------------------------------------------ d_noisy ----

// Issue the copies of ROWS rows of COLS pixels' K2 taps, top-left frame
// pixel (gy0, gx0), of an (H, W, K2) image given by element strides, into
// [ROWS][ROW] shared memory: tap t of window pixel (r, col) lands at
// sm[r * ROW + shift[r] + col * K2 + t], zero outside the frame; NT threads,
// thread `tid`. Where the taps are contiguous (tap stride 1, pixel stride
// K2: the head's softmax) a row's in-frame pixels are one run of floats:
// it lands shifted by shift[r] (0..3) floats so that its body goes in 16 B
// copies, 16 B aligned on both sides, with at most 3 floats at each end in
// 4 B copies. Other strides take a 4 B copy an element, shift 0.
// ROW >= COLS * K2 + 3; gx0 < w and gx0 + COLS > 0.
template <int K2, int NT, int ROWS, int COLS, int ROW>
__device__ __forceinline__ void stage_taps(float* sm, int* shift, const float* src, int tid,
                                           int gy0, int gx0, int h, int w, long long st,
                                           long long sy, long long sx) {
  if (st != 1 || sx != K2) {
    for (int i = tid; i < ROWS * COLS * K2; i += NT) {
      const int r = i / (COLS * K2);
      const int e = i - r * (COLS * K2);
      const int col = e / K2;
      const int gy = gy0 + r;
      const int gx = gx0 + col;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async4(sm + r * ROW + e, in ? src + gy * sy + gx * sx + (e - col * K2) * st : src, in);
    }
    for (int r = tid; r < ROWS; r += NT) shift[r] = 0;
    return;
  }
  const int ca = max(0, -gx0);  // the in-frame columns ca..cb-1
  const int cb = min(COLS, w - gx0);
  const int nel = (cb - ca) * K2;
  const int edge = (COLS - cb + ca) * K2;  // taps of the columns outside the frame
  for (int r = 0; r < ROWS; ++r) {
    const int gy = gy0 + r;
    float* row = sm + r * ROW;
    if (gy < 0 || gy >= h) {
      for (int e = tid; e < COLS * K2; e += NT) row[e] = 0.0f;
      if (tid == 0) shift[r] = 0;
      continue;
    }
    const float* g = src + gy * sy + (gx0 + ca) * K2;
    const int mis = misalignment(g);
    const int sh = (mis - ca * K2) & 3;
    if (tid == 0) shift[r] = sh;
    float* s = row + sh + ca * K2;  // s[e] is 16 B aligned where g[e] is
    const int head = min((4 - mis) & 3, nel);
    const int quads = (nel - head) / 4;
    const int tail = head + 4 * quads;
    for (int q = tid; q < quads; q += NT) cp_async16(s + head + 4 * q, g + head + 4 * q);
    if (tid < head) cp_async4(s + tid, g + tid, true);
    if (tid >= 4 && tail + tid - 4 < nel) cp_async4(s + tail + tid - 4, g + tail + tid - 4, true);
    for (int e = tid; e < edge; e += NT) {
      row[sh + (e < ca * K2 ? e : cb * K2 + e - ca * K2)] = 0.0f;
    }
  }
}

template <int K, int C, int BH>
__global__ void __launch_bounds__(BW * BH)
kpn_bwd_noisy_kernel(const float* __restrict__ g, const float* __restrict__ weights,
                     float* __restrict__ dn, int h, int w,
                     long long gsn, long long gsy, long long gsx, long long gsc,
                     long long wsn, long long wst, long long wsy, long long wsx) {
  constexpr int NT = BW * BH;
  constexpr int K2 = K * K;
  constexpr int P = K / 2;
  constexpr int TW = BW + K - 1;
  constexpr int TH = BH + K - 1;
  constexpr int WROW = (TW * K2 + 6) / 4 * 4;  // a window row of taps and up to 3 floats of shift
  constexpr int OROW = BW * C + 4;             // an output row and up to 3 floats of shift
  __shared__ __align__(16) float ws[TH * WROW];      // halo'd weight window
  __shared__ __align__(16) float gwin[C * TH * TW];  // halo'd g window
  __shared__ __align__(16) float os[BH * OROW];      // the tile's d_noisy rows
  __shared__ int shift[TH];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;
  stage<C, NT, TH, TW, TW>(gwin, g + n * gsn, tid, y0 - P, x0 - P, h, w, gsy, gsx, gsc);
  stage_taps<K2, NT, TH, TW, WROW>(ws, shift, weights + n * wsn, tid, y0 - P, x0 - P, h, w,
                                   wst, wsy, wsx);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Tap t of output pixel (u+p-dy, v+p-dx) read input pixel (u, v): window
  // pixel (ry + k-1-dy, lane + k-1-dx). A warp a row, a lane a pixel; each
  // warp stores its row when done.
  const int lane = tid % BW;
  const int ry = tid / BW;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int t = 0; t < K2; ++t) {
    const int r = ry + K - 1 - t / K;
    const int col = lane + K - 1 - t % K;
    const float wt = ws[r * WROW + shift[r] + col * K2 + t];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(gwin[(c * TH + r) * TW + col], wt, acc[c]);
  }
  float* grow = dn + ((static_cast<long long>(n) * h + y0 + ry) * w + x0) * C;
  float* srow = os + ry * OROW;
  float* o = srow + misalignment(grow) + lane * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
  __syncwarp();
  if (y0 + ry < h) store_row(grow, srow, lane, min(BW, w - x0) * C);
}

// ------------------------------------------------------------ dispatch ----

template <int K, int C, int BH>
cudaError_t launch_weights(const float* noisy, const float* g, float* dw, int n, int h, int w,
                           const long long* s, cudaStream_t stream) {
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n);
  kpn_bwd_weights_kernel<K, C, BH><<<grid, BW * BH, 0, stream>>>(
      noisy, g, dw, h, w, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return cudaGetLastError();
}

template <int K, int C, int BH>
cudaError_t launch_noisy(const float* g, const float* weights, float* dn, int n, int h, int w,
                         const long long* s, cudaStream_t stream) {
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, n);
  kpn_bwd_noisy_kernel<K, C, BH><<<grid, BW * BH, 0, stream>>>(
      g, weights, dn, h, w, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t resident(int which, int* blocks) {
  return which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, kpn_bwd_weights_kernel<K, C, TILE_ROWS>, BW * TILE_ROWS, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, kpn_bwd_noisy_kernel<K, C, TILE_ROWS>, BW * TILE_ROWS, 0);
}

}  // namespace

// Both kernels launch on `stream` and return cudaGetLastError() after the
// launch (0 = launched). The caller checks shapes, k and c; k other than 3
// or 5 and c outside 1..4 return cudaErrorInvalidValue without launching.

// d_w, (N, H, W, k*k) contiguous.
extern "C" int kpn_apply_bwd_weights_f32(const float* noisy, const float* g, float* dw,
                                         int n, int h, int w, int c, int k,
                                         long long nsn, long long nsy, long long nsx, long long nsc,
                                         long long gsn, long long gsy, long long gsx, long long gsc,
                                         void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[8] = {nsn, nsy, nsx, nsc, gsn, gsy, gsx, gsc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(k, c, [&](auto kk, auto cc) {
    constexpr int K = decltype(kk)::value, C = decltype(cc)::value;
    return launch_weights<K, C, TILE_ROWS>(noisy, g, dw, n, h, w, s, st);
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
    constexpr int K = decltype(kk)::value, C = decltype(cc)::value;
    return launch_noisy<K, C, TILE_ROWS>(g, weights, dn, n, h, w, s, st);
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
