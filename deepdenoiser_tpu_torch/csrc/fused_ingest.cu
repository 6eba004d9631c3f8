// Fused ingest for Hopper (sm_90a), fp32: the per-pass encode chain of the
// group-mode denoise, one pass over the raw render passes.
//
// Replaces the five TPU kernels of deepdenoiser_tpu/ops/fused_ingest.py,
// all launched there through _run_2d:
//
//   fused_radiance_f32     _radiance_kernel     (encode_radiance)
//       out_d = log1p(max(d / (c + eps), 0)),  out_i = log1p(max(i / (c + eps), 0))
//   fused_normal_f32       _aux_kernel          (encode_normal)
//       out = min(max(n, -1), 1)
//   fused_depth_alpha_f32  _depth_alpha_kernel  (encode_depth_alpha)
//       out_d = log1p(max(d, 0)),  out_a = min(max(a, 0), 1)
//   fused_depth_f32        _depth_kernel        (encode_depth)
//   fused_alpha_f32        _alpha_kernel        (encode_alpha)
//
// What bounds them: memory. Each element is read once and written once
// (radiance: 20 B in flight for a division and two log1p; the others 8 B
// for a clamp or a log1p), far below the card's fp32 balance point, so the
// only cost that matters is bytes moved. What the design does about it:
//
//   * No padded copy. The TPU version pads every 2-D view up to (8, 512)
//     blocks, writes padded planes and slices them. Here a flat grid-stride
//     loop walks the elements and a guarded tail takes what is left over,
//     so nothing is padded and nothing is sliced.
//   * 128-bit accesses where the buffers allow: when every input and every
//     output is dense and 16-byte aligned, a thread moves four elements as
//     one float4 per tensor. The launcher tests pointers and strides.
//   * Strided tensors. Every tensor is a (pixels, channels) view given by
//     a pixel stride and a channel stride in elements, so the caller can
//     point the outputs at channel ranges of a preallocated (..., H, W, 14)
//     network input and the channel concatenation of the TPU path (its
//     jnp.concatenate) never happens. A call with any strided tensor takes
//     the scalar kernel, in which neighbouring lanes handle neighbouring
//     elements: dense inputs are still read in full 128-byte lines, and a
//     warp's stores into the stack land in as few lines as the strides
//     allow. (A first form kept the float4 loads and let each thread
//     scatter its own four results; its stores hit 32 different lines per
//     instruction and ran several times slower.) The stores still fill
//     only part of each 32-byte sector of the stack, which is what keeps
//     the strided form away from the bound.
//
// Arithmetic follows the plain version (transforms.py): IEEE division,
// fmaxf before log1pf, clamps as fminf(fmaxf(..)); build without
// -use_fast_math. eps is an argument (transforms.DEMOD_EPS), not a constant
// of this file.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 resident blocks of 256 threads per SM

// A (pixels, channels) view: element (p, ch) lives at p * ps + ch * cs.
struct View {
  float* ptr;
  long long ps;
  long long cs;
};

template <int NIN, int NOUT>
struct Views {
  View in[NIN];
  View out[NOUT];
};

struct RadianceOp {
  static constexpr int NIN = 3;   // direct, indirect, albedo
  static constexpr int NOUT = 2;  // log-demodulated direct, indirect
  float eps;
  __device__ void operator()(const float* x, float* y) const {
    const float c = x[2] + eps;
    y[0] = log1pf(fmaxf(x[0] / c, 0.0f));
    y[1] = log1pf(fmaxf(x[1] / c, 0.0f));
  }
};

struct NormalOp {
  static constexpr int NIN = 1;
  static constexpr int NOUT = 1;
  __device__ void operator()(const float* x, float* y) const {
    y[0] = fminf(fmaxf(x[0], -1.0f), 1.0f);
  }
};

struct DepthAlphaOp {
  static constexpr int NIN = 2;  // depth, alpha
  static constexpr int NOUT = 2;
  __device__ void operator()(const float* x, float* y) const {
    y[0] = log1pf(fmaxf(x[0], 0.0f));
    y[1] = fminf(fmaxf(x[1], 0.0f), 1.0f);
  }
};

struct DepthOp {
  static constexpr int NIN = 1;
  static constexpr int NOUT = 1;
  __device__ void operator()(const float* x, float* y) const {
    y[0] = log1pf(fmaxf(x[0], 0.0f));
  }
};

struct AlphaOp {
  static constexpr int NIN = 1;
  static constexpr int NOUT = 1;
  __device__ void operator()(const float* x, float* y) const {
    y[0] = fminf(fmaxf(x[0], 0.0f), 1.0f);
  }
};

// Dense form: every tensor is contiguous and 16-byte aligned. One thread
// moves four consecutive elements per tensor as a float4; the n % 4
// leftover elements go one per thread.
template <class Op>
__global__ void __launch_bounds__(THREADS)
ingest_dense_kernel(Views<Op::NIN, Op::NOUT> v, long long n, Op op) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long groups = n / 4;
  for (long long g = tid; g < groups; g += step) {
    float x[Op::NIN][4];
    float y[Op::NOUT][4];
#pragma unroll
    for (int t = 0; t < Op::NIN; ++t) {
      const float4 q = reinterpret_cast<const float4*>(v.in[t].ptr)[g];
      x[t][0] = q.x; x[t][1] = q.y; x[t][2] = q.z; x[t][3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float xi[Op::NIN];
      float yo[Op::NOUT];
#pragma unroll
      for (int t = 0; t < Op::NIN; ++t) xi[t] = x[t][j];
      op(xi, yo);
#pragma unroll
      for (int t = 0; t < Op::NOUT; ++t) y[t][j] = yo[t];
    }
#pragma unroll
    for (int t = 0; t < Op::NOUT; ++t) {
      reinterpret_cast<float4*>(v.out[t].ptr)[g] = make_float4(y[t][0], y[t][1], y[t][2], y[t][3]);
    }
  }
  for (long long e = groups * 4 + tid; e < n; e += step) {
    float xi[Op::NIN];
    float yo[Op::NOUT];
#pragma unroll
    for (int t = 0; t < Op::NIN; ++t) xi[t] = v.in[t].ptr[e];
    op(xi, yo);
#pragma unroll
    for (int t = 0; t < Op::NOUT; ++t) v.out[t].ptr[e] = yo[t];
  }
}

// Strided form: one element per thread per step, neighbouring lanes on
// neighbouring elements. (pixel, channel) of the thread's element is found
// by one division and then carried from step to step.
template <class Op>
__global__ void __launch_bounds__(THREADS)
ingest_strided_kernel(Views<Op::NIN, Op::NOUT> v, long long n, int c, Op op) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  long long pix = e / c;
  int ch = static_cast<int>(e - pix * c);
  const long long step_pix = step / c;
  const int step_ch = static_cast<int>(step - step_pix * c);
  for (; e < n; e += step) {
    float xi[Op::NIN];
    float yo[Op::NOUT];
#pragma unroll
    for (int t = 0; t < Op::NIN; ++t) xi[t] = v.in[t].ptr[pix * v.in[t].ps + ch * v.in[t].cs];
    op(xi, yo);
#pragma unroll
    for (int t = 0; t < Op::NOUT; ++t) v.out[t].ptr[pix * v.out[t].ps + ch * v.out[t].cs] = yo[t];
    pix += step_pix;
    ch += step_ch;
    if (ch >= c) {
      ch -= c;
      ++pix;
    }
  }
}

bool dense_and_aligned(const View& v, int c) {
  return v.ps == c && v.cs == 1 && reinterpret_cast<unsigned long long>(v.ptr) % 16 == 0;
}

template <class Op>
int launch(const Views<Op::NIN, Op::NOUT>& v, long long npix, int c, Op op, void* stream) {
  if (npix < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = npix * c;
  bool dense = true;
  for (int t = 0; t < Op::NIN; ++t) dense = dense && dense_and_aligned(v.in[t], c);
  for (int t = 0; t < Op::NOUT; ++t) dense = dense && dense_and_aligned(v.out[t], c);
  const long long work = dense ? (n + 3) / 4 : n;  // threads that have something to do
  const long long want = (work + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dense) {
    ingest_dense_kernel<Op><<<blocks, THREADS, 0, s>>>(v, n, op);
  } else {
    ingest_strided_kernel<Op><<<blocks, THREADS, 0, s>>>(v, n, c, op);
  }
  return static_cast<int>(cudaGetLastError());
}

View view(const float* ptr, long long ps, long long cs) {
  return View{const_cast<float*>(ptr), ps, cs};
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError()
// after the launch (0 = launched). Tensors are (npix, c) views with a pixel
// stride and a channel stride in elements; the caller checks shapes, types
// and that outputs do not overlap.

extern "C" int fused_radiance_f32(const float* direct, const float* indirect, const float* color,
                                  float* out_direct, float* out_indirect,
                                  long long npix, int c,
                                  long long d_ps, long long d_cs, long long i_ps, long long i_cs,
                                  long long c_ps, long long c_cs,
                                  long long od_ps, long long od_cs, long long oi_ps, long long oi_cs,
                                  float eps, void* stream) {
  Views<3, 2> v;
  v.in[0] = view(direct, d_ps, d_cs);
  v.in[1] = view(indirect, i_ps, i_cs);
  v.in[2] = view(color, c_ps, c_cs);
  v.out[0] = view(out_direct, od_ps, od_cs);
  v.out[1] = view(out_indirect, oi_ps, oi_cs);
  return launch(v, npix, c, RadianceOp{eps}, stream);
}

extern "C" int fused_normal_f32(const float* normal, float* out, long long npix, int c,
                                long long n_ps, long long n_cs, long long o_ps, long long o_cs,
                                void* stream) {
  Views<1, 1> v;
  v.in[0] = view(normal, n_ps, n_cs);
  v.out[0] = view(out, o_ps, o_cs);
  return launch(v, npix, c, NormalOp{}, stream);
}

extern "C" int fused_depth_alpha_f32(const float* depth, const float* alpha,
                                     float* out_depth, float* out_alpha, long long npix, int c,
                                     long long d_ps, long long d_cs, long long a_ps, long long a_cs,
                                     long long od_ps, long long od_cs, long long oa_ps, long long oa_cs,
                                     void* stream) {
  Views<2, 2> v;
  v.in[0] = view(depth, d_ps, d_cs);
  v.in[1] = view(alpha, a_ps, a_cs);
  v.out[0] = view(out_depth, od_ps, od_cs);
  v.out[1] = view(out_alpha, oa_ps, oa_cs);
  return launch(v, npix, c, DepthAlphaOp{}, stream);
}

extern "C" int fused_depth_f32(const float* depth, float* out, long long npix, int c,
                               long long d_ps, long long d_cs, long long o_ps, long long o_cs,
                               void* stream) {
  Views<1, 1> v;
  v.in[0] = view(depth, d_ps, d_cs);
  v.out[0] = view(out, o_ps, o_cs);
  return launch(v, npix, c, DepthOp{}, stream);
}

extern "C" int fused_alpha_f32(const float* alpha, float* out, long long npix, int c,
                               long long a_ps, long long a_cs, long long o_ps, long long o_cs,
                               void* stream) {
  Views<1, 1> v;
  v.in[0] = view(alpha, a_ps, a_cs);
  v.out[0] = view(out, o_ps, o_cs);
  return launch(v, npix, c, AlphaOp{}, stream);
}
