// A conv's epilogue for Hopper (sm_90a), bf16 or fp32, in one pass:
//
//   out = act(round(z + b))      round: to the tensor's dtype
//
// over a dense (N, C, H, W) conv output z, channels-last or contiguous NCHW,
// with b the layer's fp32 bias, rounded to the dtype first, as
// `b.to(dtype)` does. act is none, relu, leaky_relu (slope 0.2), elu,
// tanh-gelu or silu. The arithmetic is the plain chain's
// (ops/bias_act.py, bias_act_plain), which is what PyTorch runs after a
// cuDNN conv: the bias added in fp32 and rounded, the activation computed
// in fp32 on the rounded sum and rounded again, with PyTorch's expressions
// for each activation. So none, relu and leaky_relu give the plain chain's
// bits; elu, gelu and silu may differ from it in the last bit, where
// expm1f, tanhf and expf are contracted or ordered otherwise.
//
// It replaces no TPU kernel: XLA fuses the bias and the activation into
// the conv on the TPU. In PyTorch the two were passes of their own after
// cuDNN: a broadcast add of the bias over the channels-last output, which
// PyTorch runs as a strided elementwise loop (about 40 % of its bytes
// floor), then the activation, which reads and writes the tensor again.
//
// What bounds it: memory. Each element is read once and written once with
// a few operations between. At kpn-hq's 1080p plane the 20 conv outputs and
// the 200-channel head are 3.78 GB of bf16 a frame: 7.56 GB moved, 2.26 ms
// at 3.35 TB/s.
//
// The design, against that bound:
//   - The tensor is a flat array of n elements whatever C is (50 channels
//     do not divide a vector): thread i of the grid owns 16 B vectors i,
//     i + NT, ... of its block's span, UNROLL of them, all loaded before
//     the first is used, so each thread has UNROLL independent 16 B loads
//     in flight (NT = 128 threads, 8 KB a block).
//   - An element's channel is found once a vector: e % C channels-last,
//     (e / HW) % C in NCHW; the rest of the vector steps the channel on.
//   - The bias, rounded to the dtype, is staged in shared memory while the
//     block's loads are in flight (C floats, at most 48 KB).
//   - The output may be z itself: the frame path writes in place, with no
//     allocation. Each element is read before it is written, by the same
//     thread, so the in-place write needs no ordering.
//   - z and out are 16 B aligned (a fresh allocation is; the wrapper
//     refuses other addresses); the elements after the last whole vector
//     are done by the last block.
//
// The sub-pixel instantiation (SUBPIXEL) is the epilogue of the decoder's
// resize-conv (models/layers.py, UpSample): nearest-resize x2 and a 3x3
// SAME conv, run as a 2x2 conv with padding 1 and 4F outputs on the coarse
// (H, W) grid. Its z is that conv's (N, 4F, H+1, W+1) output, channels-last;
// the kernel writes a new (N, F, 2H, 2W) channels-last tensor:
//
//   out[n, f, 2i+r, 2j+q] = act(round(z[n, (2r+q)F + f, i+r, j+q] + b[f]))
//
// so it interleaves the four output phases as it adds the bias, and the
// full-resolution phase shuffle (depth_to_space) never runs on its own.
// Each thread walks z as the plain kernel does, and stores to the phase's
// place: z pixel (a, b), channel block 2r + q, goes to output pixel
// (2a - r, 2b - q); the blocks of the border that no output pixel has
// (row 0's r = 1, row H's r = 0, and so for the columns) are neither read
// nor written. The three divisions of the index are multiplies with magic
// numbers made on the host. So the reads run along z as in the plain kernel,
// and the stores of a z row run along two output rows, 2a - 1 and 2a. A
// phase's F channels are one contiguous run of both tensors, so where F is
// a multiple of a vector (16 B) every vector is one 16 B load and one 16 B
// store; other F take one element a load. It reads 4HWF elements of z and
// writes as many: the bytes of the plain kernel on the full-resolution conv
// output it replaces.
//
// The wide instantiation (bias_act_kernel_wide) takes a z of more than
// 2**31 - 1 elements: the logits of the KPCN's 882-output conv, 7.92e9 at
// its 1080p plane. The launch picks it by size, so every smaller tensor
// runs the 32-bit kernel above. Each block finds its own span of NT*UNROLL
// vectors from a 64-bit base and steps z and out to it; inside the span
// the indices, the channel walk and the tail are the 32-bit ones above,
// from a flat index that has the span's first element's channel (and, in
// NCHW, its place in the plane): for channels-last the span start's
// channel is a product of two residues, in 32 bits; for NCHW it takes
// 64-bit divisions, once a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 128;       // threads a block
constexpr int UNROLL = 4;     // 16 B vectors a thread
constexpr int MAX_C = 12288;  // channels: the staged bias fits 48 KB of shared memory

enum Act { NONE = 0, RELU = 1, LEAKY_RELU = 2, ELU = 3, GELU = 4, SILU = 5 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as PyTorch's conversion
}

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// PyTorch's CUDA expressions, in fp32 (its opmath type for bf16 and fp32)
template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == RELU) return isnan(y) ? y : fmaxf(y, 0.0f);  // clamp_min(y, 0)
  if (ACT == LEAKY_RELU) return y > 0.0f ? y : y * 0.2f;
  if (ACT == ELU) return y > 0.0f ? y : expm1f(y);  // alpha = scale = input_scale = 1
  if (ACT == GELU) {
    // M_SQRT2 * M_2_SQRTPI * 0.5, taken in double and rounded once
    constexpr float kBeta =
        static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
    constexpr float kKappa = 0.044715f;
    const float cube = y * y * y;
    const float inner = kBeta * (y + kKappa * cube);
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  if (ACT == SILU) return y / (1.0f + expf(-y));
  return y;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// vector i of a flat array, as one 16 B access where V elements are 16 B
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* a, unsigned i) {
  Pack<T, V> p;
  if constexpr (sizeof(p) == 16) {
    *reinterpret_cast<uint4*>(&p) = reinterpret_cast<const uint4*>(a)[i];
  } else {
    p = reinterpret_cast<const Pack<T, V>*>(a)[i];
  }
  return p;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* a, unsigned i, const Pack<T, V>& p) {
  if constexpr (sizeof(p) == 16) {
    reinterpret_cast<uint4*>(a)[i] = *reinterpret_cast<const uint4*>(&p);
  } else {
    reinterpret_cast<Pack<T, V>*>(a)[i] = p;
  }
}

// the V elements from flat index e on, in place
template <typename T, int ACT, bool PLANAR, int V>
__device__ __forceinline__ void apply(Pack<T, V>& p, unsigned e, const float* sb, unsigned c,
                                      unsigned hw) {
  unsigned ch, r = 0;
  if (PLANAR) {
    const unsigned q = e / hw;
    r = e - q * hw;
    ch = q % c;
  } else {
    ch = e % c;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float y = round_to<T>(to_f<T>(p.v[j]) + sb[ch]);
    p.v[j] = from_f<T>(activate<ACT>(y));
    if (PLANAR) {
      if (++r == hw) {
        r = 0;
        if (++ch == c) ch = 0;
      }
    } else if (++ch == c) {
      ch = 0;
    }
  }
}

// n / d for n < 2**31 as a multiply-high, an add and a shift, with the
// divisor's magic number made on the host (PyTorch's IntDivider)
struct Divider {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const { return (__umulhi(n, m) + n) >> s; }
};

Divider divider(unsigned d) {
  unsigned s = 0;
  while ((1U << s) < d) ++s;
  const uint64_t m = ((uint64_t{1} << 32) * ((uint64_t{1} << s) - d)) / d + 1;
  return Divider{d, static_cast<unsigned>(m), s};
}

// SUBPIXEL: vectors a phase's run of F channels, and the phase tensor's
// columns (W+1) and rows (H+1)
struct Phases {
  Divider vectors, wz, hz;
};

constexpr unsigned NOWHERE = 0xffffffffu;

// where vector i of z goes in the output: i itself, or for SUBPIXEL its
// phase's pixel, vector (n, 2a-r, 2b-q, f) of the output for vector (n, a,
// b, 2r+q, f) of z; NOWHERE for the border phases that no output pixel has
template <bool SUBPIXEL>
__device__ __forceinline__ unsigned destination(unsigned i, const Phases& g) {
  if constexpr (SUBPIXEL) {
    const unsigned run = g.vectors.div(i), f = i - run * g.vectors.d;
    const unsigned pixel = run >> 2, r = (run >> 1) & 1, q = run & 1;
    const unsigned t = g.wz.div(pixel), b = pixel - t * g.wz.d;
    const unsigned nb = g.hz.div(t), a = t - nb * g.hz.d;
    const unsigned h2 = 2 * (g.hz.d - 1), w2 = 2 * (g.wz.d - 1);
    const unsigned y = 2 * a - r, x = 2 * b - q;  // row -1 or column -1 wraps past h2, w2
    if (y >= h2 || x >= w2) return NOWHERE;
    return ((nb * h2 + y) * w2 + x) * g.vectors.d + f;
  } else {
    return i;
  }
}

// n: z's elements; c the output's channels; hw its H*W (PLANAR); g the
// phase tensor's shape (SUBPIXEL)
template <typename T, int ACT, bool PLANAR, bool SUBPIXEL, int V>
__global__ void __launch_bounds__(NT)
bias_act_kernel(const T* z, const float* __restrict__ bias, T* out, unsigned n, unsigned c,
                unsigned hw, Phases g) {
  extern __shared__ float sb[];
  using P = Pack<T, V>;
  const unsigned nvec = n / V;
  const unsigned first = blockIdx.x * (NT * UNROLL) + threadIdx.x;
  P p[UNROLL];
  unsigned to[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = first + u * NT;
    to[u] = i < nvec ? destination<SUBPIXEL>(i, g) : NOWHERE;
    if (to[u] != NOWHERE) p[u] = load<T, V>(z, i);
  }
  for (unsigned k = threadIdx.x; k < c; k += NT) sb[k] = round_to<T>(__ldg(bias + k));
  __syncthreads();
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (to[u] != NOWHERE) {
      apply<T, ACT, PLANAR, V>(p[u], to[u] * V, sb, c, hw);
      store<T, V>(out, to[u], p[u]);
    }
  }
  // a sub-pixel launch's vectors never straddle a phase's run, so it has no tail
  if (!SUBPIXEL && blockIdx.x == gridDim.x - 1) {
    for (unsigned e = nvec * V + threadIdx.x; e < n; e += NT) {
      Pack<T, 1> one = load<T, 1>(z, e);
      apply<T, ACT, PLANAR, 1>(one, e, sb, c, hw);
      store<T, 1>(out, e, one);
    }
  }
}

// the wide instantiation: n > 2**31 - 1 elements; the span of block b
// starts at element b * NT * UNROLL * V
template <typename T, int ACT, bool PLANAR, int V>
__global__ void __launch_bounds__(NT)
bias_act_kernel_wide(const T* z, const float* __restrict__ bias, T* out, unsigned long long n,
                     unsigned c, unsigned hw) {
  extern __shared__ float sb[];
  using P = Pack<T, V>;
  constexpr unsigned SPAN = NT * UNROLL * V;
  const unsigned long long base = static_cast<unsigned long long>(blockIdx.x) * SPAN;
  const unsigned ne = static_cast<unsigned>(min(n - base, static_cast<unsigned long long>(SPAN)));
  unsigned e0;  // a flat index whose channel (and place in the plane) is base's
  if (PLANAR) {
    const unsigned long long q = base / hw;
    e0 = static_cast<unsigned>(q % c) * hw + static_cast<unsigned>(base - q * hw);
  } else {
    e0 = (blockIdx.x % c) * (SPAN % c) % c;
  }
  z += base;
  out += base;
  const unsigned nvec = ne / V;
  P p[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = threadIdx.x + u * NT;
    if (i < nvec) p[u] = load<T, V>(z, i);
  }
  for (unsigned k = threadIdx.x; k < c; k += NT) sb[k] = round_to<T>(__ldg(bias + k));
  __syncthreads();
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = threadIdx.x + u * NT;
    if (i < nvec) {
      apply<T, ACT, PLANAR, V>(p[u], e0 + i * V, sb, c, hw);
      store<T, V>(out, i, p[u]);
    }
  }
  for (unsigned e = nvec * V + threadIdx.x; e < ne; e += NT) {  // the last span's tail
    Pack<T, 1> one = load<T, 1>(z, e);
    apply<T, ACT, PLANAR, 1>(one, e0 + e, sb, c, hw);
    store<T, 1>(out, e, one);
  }
}

// where a launch writes: the layout of z and out
enum Layout { CHANNELS_LAST = 0, PLANAR_NCHW = 1, PHASES = 2 };

// n: z's elements; c the output's channels; hw its H*W; wz, hz the phase
// tensor's columns and rows (W+1, H+1)
struct Shape {
  unsigned long long n;
  unsigned c, hw, wz, hz;
};

constexpr unsigned long long MAX_32 = 0x7fffffffULL;  // the 32-bit kernel's elements
constexpr unsigned MAX_SPAN = NT * UNROLL * 8;      // a wide block's elements, at most

template <typename T, int ACT, bool PLANAR, bool SUBPIXEL, int V>
cudaError_t launch(const void* z, const float* bias, void* out, Shape s, cudaStream_t stream) {
  const unsigned n = static_cast<unsigned>(s.n);
  const unsigned per_block = NT * UNROLL;
  const unsigned blocks = n / V < per_block ? 1 : (n / V + per_block - 1) / per_block;
  const Phases g{divider(SUBPIXEL ? s.c / V : 1), divider(s.wz), divider(s.hz)};
  bias_act_kernel<T, ACT, PLANAR, SUBPIXEL, V><<<blocks, NT, s.c * sizeof(float), stream>>>(
      static_cast<const T*>(z), bias, static_cast<T*>(out), n, s.c, s.hw, g);
  return cudaGetLastError();
}

template <typename T, int ACT, bool PLANAR, int V>
cudaError_t launch_wide(const void* z, const float* bias, void* out, Shape s,
                        cudaStream_t stream) {
  constexpr unsigned long long span = NT * UNROLL * V;
  const unsigned long long blocks = (s.n + span - 1) / span;
  if (blocks > MAX_32) return cudaErrorInvalidValue;
  bias_act_kernel_wide<T, ACT, PLANAR, V>
      <<<static_cast<unsigned>(blocks), NT, s.c * sizeof(float), stream>>>(
          static_cast<const T*>(z), bias, static_cast<T*>(out), s.n, s.c, s.hw);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_layout(const void* z, const float* bias, void* out, int layout, Shape s,
                          cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (s.n > MAX_32) {  // chosen by size: every smaller tensor takes the 32-bit kernel
    switch (layout) {
      case CHANNELS_LAST: return launch_wide<T, ACT, false, V>(z, bias, out, s, stream);
      case PLANAR_NCHW: return launch_wide<T, ACT, true, V>(z, bias, out, s, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (layout) {
    case CHANNELS_LAST: return launch<T, ACT, false, false, V>(z, bias, out, s, stream);
    case PLANAR_NCHW: return launch<T, ACT, true, false, V>(z, bias, out, s, stream);
    case PHASES:
      // a vector is one pixel's run of z only where it cannot straddle two
      return s.c % V == 0 ? launch<T, ACT, false, true, V>(z, bias, out, s, stream)
                          : launch<T, ACT, false, true, 1>(z, bias, out, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_act(int act, const void* z, const float* bias, void* out, int layout,
                       Shape s, cudaStream_t stream) {
  switch (act) {
    case NONE: return launch_layout<T, NONE>(z, bias, out, layout, s, stream);
    case RELU: return launch_layout<T, RELU>(z, bias, out, layout, s, stream);
    case LEAKY_RELU: return launch_layout<T, LEAKY_RELU>(z, bias, out, layout, s, stream);
    case ELU: return launch_layout<T, ELU>(z, bias, out, layout, s, stream);
    case GELU: return launch_layout<T, GELU>(z, bias, out, layout, s, stream);
    case SILU: return launch_layout<T, SILU>(z, bias, out, layout, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dtype(int dtype, int act, const void* z, const float* bias, void* out,
                         int layout, Shape s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_act<float>(act, z, bias, out, layout, s, st);
  if (dtype == 1) return launch_act<__nv_bfloat16>(act, z, bias, out, layout, s, st);
  return cudaErrorInvalidValue;
}

bool aligned(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; }

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched). z and out: n elements of a dense (N, C, H, W) tensor,
// channels-last (planar 0) or contiguous NCHW (planar 1, hw = H*W); out may
// be z. dtype 0 is fp32, 1 bf16; act as the enum above; bias c fp32 values.
// n over 2**31 - 1 takes the wide instantiation. The caller checks shapes,
// strides and devices; n < 1, c outside 1..12288, hw outside 1..2**31-1,
// an NCHW z over 2**31 - 1 elements whose C*H*W passes 2**32 less a
// block's span, z or out not 16 B aligned, or an unknown dtype or act
// return cudaErrorInvalidValue without launching.
extern "C" int bias_act(const void* z, const float* bias, void* out, int dtype, int act,
                        int planar, long long n, int c, long long hw, void* stream) {
  if (n < 1 || c < 1 || c > MAX_C || hw < 1 || hw > n || hw > 0x7fffffffLL || !aligned(z) ||
      !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planar && static_cast<unsigned long long>(n) > MAX_32 &&
      static_cast<unsigned long long>(c) * hw > 0xffffffffULL - MAX_SPAN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{static_cast<unsigned long long>(n), static_cast<unsigned>(c),
                static_cast<unsigned>(hw), 1, 1};
  return static_cast<int>(
      launch_dtype(dtype, act, z, bias, out, planar ? PLANAR_NCHW : CHANNELS_LAST, s, stream));
}

// The sub-pixel epilogue: z a channels-last (N, 4c, h+1, w+1) phase tensor,
// out a new channels-last (N, c, 2h, 2w) tensor (not z), n = N*c*4*h*w
// its elements. Launches on `stream` and returns cudaGetLastError() after
// the launch. z's elements or n outside 1..2**31-1, c outside 1..12288, h
// or w < 1, n not a whole number of output images, z or out not 16 B
// aligned, or an unknown dtype or act return cudaErrorInvalidValue without
// launching.
extern "C" int bias_act_subpixel(const void* z, const float* bias, void* out, int dtype, int act,
                                 long long n, int c, long long h, long long w, void* stream) {
  if (c < 1 || c > MAX_C || h < 1 || w < 1 || n < 1 || n > 0x7fffffffLL || !aligned(z) ||
      !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long image = 4LL * h * w * c, nz = (n / image) * (h + 1) * (w + 1) * 4 * c;
  if (n % image != 0 || nz > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{static_cast<unsigned long long>(nz), static_cast<unsigned>(c), 1,
                static_cast<unsigned>(w + 1), static_cast<unsigned>(h + 1)};
  return static_cast<int>(launch_dtype(dtype, act, z, bias, out, PHASES, s, stream));
}
