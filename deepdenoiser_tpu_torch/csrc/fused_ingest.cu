// Fused ingest for Hopper (sm_90a), fp32: the per-pass encode chain of the
// group-mode and joint-mode denoise, one pass over the raw render passes.
//
// Replaces the five TPU kernels of deepdenoiser_tpu/ops/fused_ingest.py,
// all launched there through _run_2d, and their assembler
// encode_group_inputs_pallas:
//
//   RadianceOp    _radiance_kernel     (encode_radiance)
//       out_d = log1p(max(d / (c + eps), 0)),  out_i = log1p(max(i / (c + eps), 0))
//   NormalOp      _aux_kernel          (encode_normal)
//       out = min(max(n, -1), 1)
//   DepthAlphaOp  _depth_alpha_kernel  (encode_depth_alpha)
//       out_d = log1p(max(d, 0)),  out_a = min(max(a, 0), 1)
//   DepthOp       _depth_kernel        (encode_depth)
//   AlphaOp       _alpha_kernel        (encode_alpha)
//
// The five __device__ bodies below are the single definition of that
// arithmetic. Three launchers run them:
//
//   fused_group_encode_f32   every light group's whole network input in one
//                            launch: the group path of the frame denoise
//   fused_joint_encode_f32   the joint frame's padded plane in one launch:
//                            the joint path of the frame denoise
//   fused_<pass>_f32         one body alone, dense (float4) or strided
//
// The joint encode replaces no TPU kernel: the JAX package's joint encode
// (transforms.encode_joint_inputs, then inference/tiled.pad_plane) is
// plain XLA, which fuses it. In PyTorch the same chain is 16 elementwise
// passes, a concatenation on the last axis that copies with a 164-byte
// stride, and the plane's permute, reflection pad and copy back: each byte
// of the plane is written several times. The kernel writes it once.
//
// What bounds them: memory. An element is read once and written once
// (radiance: 20 B for a division and two log1p; the others 8 B for a clamp
// or a log1p), far below the card's fp32 balance point, so the only cost
// that matters is bytes moved and how whole the card's 32-byte sectors are
// when they move. What the design does about it:
//
//   * Whole pixels, once (group_encode_kernel). The network reads a
//     (groups, pixels, C) stack, C = 9 + aux channels, a pixel being
//     [enc direct 3 | enc indirect 3 | albedo 3 | aux...]. Writing it pass
//     by pass stores 12 or 4 bytes out of every 4*C, so each sector of a
//     stack far larger than the L2 is filled in parts by several launches
//     and fetched again in between. Here a block owns TILE_PIXELS
//     consecutive pixels: it reads the shared aux passes once and keeps
//     their encoded values in registers, then for every group reads direct,
//     indirect and albedo as float4s, lays the pixel-major tile out in
//     shared memory and copies it to the stack, which is contiguous there,
//     with float4 stores, neighbouring lanes on neighbouring 16 bytes. Every
//     sector of the stack is written whole, once; the albedo copy rides
//     along; the aux passes are read once per frame, not once per group.
//     The next group's loads are started before the current tile is copied
//     out, so they overlap the stores.
//   * Alignment without a second route. TILE_PIXELS * C * 4 is a multiple
//     of 16 for every C, but group g's first float, g * pixels * C, need not
//     be a multiple of 4 when the frame is ragged. The tile therefore sits
//     in shared memory at the same offset modulo 4 floats as in the stack,
//     so an aligned float4 of one is an aligned float4 of the other; up to
//     three floats at either end, and the short last tile of a frame, go
//     one by one.
//   * Shared-memory banks. A lane holds a float4 of a 3-channel pass and
//     scatters its four elements to pixel e/3, channel e%3 of the tile, so
//     neighbouring lanes write 4*C/3 words apart: two- to four-way
//     conflicts, accepted, since the tile passes through shared memory at a
//     small fraction of its bandwidth. The copy-out reads it conflict-free.
//   * The padded plane, once (joint_encode_kernel). The joint network reads
//     a (PH, PW, C) fp32 plane, C = 9 * groups + aux channels (41): the
//     frame's pixels encoded, mirrored (or, where a pad is not smaller
//     than the frame, edge-repeated) into a border of the plane's halo and
//     grid rounding. Its bound is bytes: each pass read once and the plane
//     written once, 340 MB in and 372 MB out at 1080p (0.213 ms). A block
//     owns JOINT_PIXELS consecutive plane pixels, one a thread: each finds
//     its frame pixel once by the border rule (a shared table), then every
//     lane issues all its loads of every group's direct, indirect and
//     albedo and of the aux passes before the first result is computed
//     (41 loads in flight a lane), lays the encoded pixels out in shared
//     memory and copies the tile to the plane with float4 stores,
//     neighbouring lanes on neighbouring 16 bytes: every sector of the
//     plane is written whole, once. The run starts on the float4 grid
//     (JOINT_PIXELS * C is a multiple of 4), so no offset is needed. The
//     border re-reads frame pixels the interior reads too (about 9 % more
//     reads at 1080p), from rows that neighbouring blocks read at about the
//     same time, so mostly from the L2; at the 4K tile plan the bottom pad
//     mirrors rows read 470 plane rows earlier, past what the L2 holds.
//     Loads are not unrolled further: a lane's 41 independent loads and
//     four resident blocks an SM (60 registers a thread) keep more bytes
//     in flight than the memory system needs. Measured on an H100 (the
//     benchmark's traced runs) it reaches 84 % of its bound at 1080p, 80 %
//     at the 4K plan. Its clamps pass NaN on, as PyTorch's do, so the plane equals
//     the plain chain bit for bit.
//   * Dense form (ingest_dense_kernel), for a pass alone. The grid is sized
//     to the work: a thread starts DENSE_UNROLL independent float4 loads per
//     input before its first store and never loops, indices are 32-bit when
//     the element count allows, and loads and stores carry the streaming
//     hint (every byte is touched once; the frame's other tensors want the
//     L2). Measured, all of this moves a 1080p pass by a few per cent at
//     most: the one-input passes run level with the same clamp as one
//     library call, which is what the memory system gives a read-once,
//     write-once stream of this size. An earlier form (a capped grid of
//     256-thread blocks in a grid-stride loop with 64-bit indices, one
//     float4 in flight per thread and input) was measured a fifth to a
//     third slower than that call.
//   * Strided form (ingest_strided_kernel), for a caller that points the
//     outputs at channel ranges of a wider tensor: every tensor is a
//     (pixels, channels) view given by a pixel stride and a channel stride
//     in elements, one element per thread in a grid-stride loop,
//     neighbouring lanes on neighbouring elements. Its stores fill only
//     part of each sector, which keeps it several times above its bound,
//     where the same clamp as one library call writing into the same view
//     also is; the frame path does not use it.
//
// Arithmetic follows the plain version (transforms.py): IEEE division,
// fmaxf before log1pf, clamps as fminf(fmaxf(..)); build without
// -use_fast_math. eps is an argument (transforms.DEMOD_EPS), not a constant
// of this file.
//
// DENSE_THREADS, DENSE_UNROLL and where the streaming hint stands are what
// was measured fastest on an H100 for the one-input passes and for the group
// encode: 128 against 256 threads and 1, 2 or 4 loads in flight move a
// one-input pass by under 1 %; the hint helps the 1-channel pass by 3 % and,
// put on the group encode's loads, costs it 11 %, so those are plain. The
// three-input radiance pass would gain 3 % from no hint and no unrolling,
// and keeps the one-input passes' setting.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // strided and group kernels
constexpr int MAX_BLOCKS = 132 * 8;  // strided kernel: 8 resident blocks of 256 threads per SM
constexpr int DENSE_THREADS = 256;
constexpr int DENSE_UNROLL = 2;
constexpr int TILE_PIXELS = 256;  // group kernel; ops/fused_ingest.py: GROUP_TILE_PIXELS
constexpr int MAX_GROUPS = 8;     // group kernel; ops/fused_ingest.py: GROUP_CAPACITY
constexpr int JOINT_PIXELS = 256;    // joint kernel: plane pixels per block, one a thread
constexpr int MAX_JOINT_GROUPS = 4;  // joint kernel; ops/fused_ingest.py: JOINT_CAPACITY

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

// NaN through the clamps. With KEEP_NAN a body passes a NaN on as
// PyTorch's clamp and clamp_min do (`v != v ? v : max(v, lo)`): the joint
// encode, which equals the plain chain bit for bit. Without it fmaxf and
// fminf turn a NaN into the bound: the group encode and the per-pass
// kernels.
struct RadianceOp {
  static constexpr int NIN = 3;   // direct, indirect, albedo
  static constexpr int NOUT = 2;  // log-demodulated direct, indirect
  float eps;
  template <bool KEEP_NAN>
  __device__ void apply(const float* x, float* y) const {
    const float c = x[2] + eps;
    const float u = x[0] / c;
    const float v = x[1] / c;
    y[0] = log1pf(KEEP_NAN && u != u ? u : fmaxf(u, 0.0f));
    y[1] = log1pf(KEEP_NAN && v != v ? v : fmaxf(v, 0.0f));
  }
  __device__ void operator()(const float* x, float* y) const { apply<false>(x, y); }
};

struct NormalOp {
  static constexpr int NIN = 1;
  static constexpr int NOUT = 1;
  template <bool KEEP_NAN>
  __device__ void apply(const float* x, float* y) const {
    y[0] = KEEP_NAN && x[0] != x[0] ? x[0] : fminf(fmaxf(x[0], -1.0f), 1.0f);
  }
  __device__ void operator()(const float* x, float* y) const { apply<false>(x, y); }
};

struct DepthAlphaOp {
  static constexpr int NIN = 2;  // depth, alpha
  static constexpr int NOUT = 2;
  template <bool KEEP_NAN>
  __device__ void apply(const float* x, float* y) const {
    y[0] = log1pf(KEEP_NAN && x[0] != x[0] ? x[0] : fmaxf(x[0], 0.0f));
    y[1] = KEEP_NAN && x[1] != x[1] ? x[1] : fminf(fmaxf(x[1], 0.0f), 1.0f);
  }
  __device__ void operator()(const float* x, float* y) const { apply<false>(x, y); }
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

// Dense form: every tensor is contiguous and 16-byte aligned. A block takes
// DENSE_THREADS * DENSE_UNROLL consecutive float4s of each tensor; a thread
// loads its DENSE_UNROLL of every input (DENSE_THREADS float4s apart, so a
// warp's accesses stay contiguous) before it computes and stores. The n % 4
// leftover elements go one per thread of block 0. Index is unsigned int
// when n < 2^31, else long long.
template <class Op, class Index>
__global__ void __launch_bounds__(DENSE_THREADS)
ingest_dense_kernel(Views<Op::NIN, Op::NOUT> v, Index quads, Index n, Op op) {
  const Index first = static_cast<Index>(blockIdx.x) * (DENSE_THREADS * DENSE_UNROLL) + threadIdx.x;
  float x[Op::NIN][DENSE_UNROLL][4];
#pragma unroll
  for (int k = 0; k < DENSE_UNROLL; ++k) {
    const Index q = first + k * DENSE_THREADS;
    if (q < quads) {
#pragma unroll
      for (int t = 0; t < Op::NIN; ++t) {
        const float4 f = __ldcs(reinterpret_cast<const float4*>(v.in[t].ptr) + q);
        x[t][k][0] = f.x; x[t][k][1] = f.y; x[t][k][2] = f.z; x[t][k][3] = f.w;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < DENSE_UNROLL; ++k) {
    const Index q = first + k * DENSE_THREADS;
    if (q < quads) {
      float y[Op::NOUT][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float xi[Op::NIN];
        float yo[Op::NOUT];
#pragma unroll
        for (int t = 0; t < Op::NIN; ++t) xi[t] = x[t][k][j];
        op(xi, yo);
#pragma unroll
        for (int t = 0; t < Op::NOUT; ++t) y[t][j] = yo[t];
      }
#pragma unroll
      for (int t = 0; t < Op::NOUT; ++t) {
        __stcs(reinterpret_cast<float4*>(v.out[t].ptr) + q,
               make_float4(y[t][0], y[t][1], y[t][2], y[t][3]));
      }
    }
  }
  const Index e = quads * 4 + threadIdx.x;
  if (blockIdx.x == 0 && e < n) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dense) {
    constexpr long long per_block = DENSE_THREADS * DENSE_UNROLL;
    const long long quads = n / 4;
    const long long blocks = quads > 0 ? (quads + per_block - 1) / per_block : 1;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned int grid = static_cast<unsigned int>(blocks);
    if (n < (1LL << 31)) {
      ingest_dense_kernel<Op, unsigned int><<<grid, DENSE_THREADS, 0, s>>>(
          v, static_cast<unsigned int>(quads), static_cast<unsigned int>(n), op);
    } else {
      ingest_dense_kernel<Op, long long><<<grid, DENSE_THREADS, 0, s>>>(v, quads, n, op);
    }
  } else {
    const long long want = (n + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
    ingest_strided_kernel<Op><<<blocks, THREADS, 0, s>>>(v, n, c, op);
  }
  return static_cast<int>(cudaGetLastError());
}

View view(const float* ptr, long long ps, long long cs) {
  return View{const_cast<float*>(ptr), ps, cs};
}

// ---------------------------------------------------------------------------
// The whole-pixel group encode
// ---------------------------------------------------------------------------

struct GroupArgs {
  const float* direct[MAX_GROUPS];  // dense (npix, 3), 16-byte aligned
  const float* indirect[MAX_GROUPS];
  const float* albedo[MAX_GROUPS];
  const float* normal;  // dense (npix, 3) or null
  const float* depth;   // dense (npix, 1) or null
  const float* alpha;   // dense (npix, 1) or null
  float* out;           // dense (groups, npix, C), 16-byte aligned
  long long npix;
  int groups;
  int off_normal, off_depth, off_alpha;  // first channel of each aux pass within a pixel
  float eps;
};

// Floats [4q, 4q + 4) of a 16-byte-aligned run of n floats; 0 past its end.
__device__ __forceinline__ void load_quad(const float* run, int q, int n, float* v) {
  if (4 * q + 4 <= n) {
    const float4 f = reinterpret_cast<const float4*>(run)[q];
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = 4 * q + j < n ? run[4 * q + j] : 0.0f;
    }
  }
}

// One block per tile of TILE_PIXELS consecutive pixels, all groups. Lanes
// 0..191 each hold one float4 of a 3-channel pass of the tile (768 floats),
// lanes 0..63 one float4 of a 1-channel pass.
template <bool NORMAL, bool DEPTH, bool ALPHA>
__global__ void __launch_bounds__(THREADS, 4)
group_encode_kernel(GroupArgs a) {
  constexpr int C = 9 + 3 * NORMAL + DEPTH + ALPHA;
  static_assert((TILE_PIXELS * C * 4) % 16 == 0, "a tile must be a whole number of float4s");
  static_assert(TILE_PIXELS % 4 == 0 && TILE_PIXELS * 3 / 4 <= THREADS,
                "one float4 of a 3-channel pass per lane");
  __shared__ __align__(16) float tile[TILE_PIXELS * C + 4];

  const int tid = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * TILE_PIXELS;
  const long long left = a.npix - p0;
  const int valid = left < TILE_PIXELS ? static_cast<int>(left) : TILE_PIXELS;
  const bool rgb_lane = tid < TILE_PIXELS * 3 / 4;
  const bool one_lane = tid < TILE_PIXELS / 4;
  const RadianceOp radiance{a.eps};

  float d[4], i[4], c[4];  // this lane's float4 of the group's direct, indirect, albedo
  if (rgb_lane) {
    load_quad(a.direct[0] + p0 * 3, tid, valid * 3, d);
    load_quad(a.indirect[0] + p0 * 3, tid, valid * 3, i);
    load_quad(a.albedo[0] + p0 * 3, tid, valid * 3, c);
  }

  // the shared aux passes: read and encoded once, kept for every group
  float nrm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dep[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float alp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (NORMAL && rgb_lane) {
    float x[4];
    load_quad(a.normal + p0 * 3, tid, valid * 3, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) NormalOp{}(&x[j], &nrm[j]);
  }
  if ((DEPTH || ALPHA) && one_lane) {
    float xd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float xa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (DEPTH) load_quad(a.depth + p0, tid, valid, xd);
    if (ALPHA) load_quad(a.alpha + p0, tid, valid, xa);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (DEPTH && ALPHA) {
        const float x[2] = {xd[j], xa[j]};
        float y[2];
        DepthAlphaOp{}(x, y);
        dep[j] = y[0];
        alp[j] = y[1];
      } else if (DEPTH) {
        DepthOp{}(&xd[j], &dep[j]);
      } else {
        AlphaOp{}(&xa[j], &alp[j]);
      }
    }
  }

  for (int g = 0; g < a.groups; ++g) {
    // flat index in `out` of the tile's first float, and its offset in a float4
    const long long first = (static_cast<long long>(g) * a.npix + p0) * C;
    const int m = static_cast<int>(first & 3);
    float* s = tile + m;
    if (rgb_lane) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * tid + j;
        const int px = e / 3;
        float* dst = s + px * C + (e - 3 * px);
        const float x[3] = {d[j], i[j], c[j]};
        float y[2];
        radiance(x, y);
        dst[0] = y[0];
        dst[3] = y[1];
        dst[6] = c[j];
        if (NORMAL) dst[a.off_normal] = nrm[j];
      }
    }
    if ((DEPTH || ALPHA) && one_lane) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* dst = s + (4 * tid + j) * C;
        if (DEPTH) dst[a.off_depth] = dep[j];
        if (ALPHA) dst[a.off_alpha] = alp[j];
      }
    }
    if (g + 1 < a.groups && rgb_lane) {  // in flight while this tile is copied out
      load_quad(a.direct[g + 1] + p0 * 3, tid, valid * 3, d);
      load_quad(a.indirect[g + 1] + p0 * 3, tid, valid * 3, i);
      load_quad(a.albedo[g + 1] + p0 * 3, tid, valid * 3, c);
    }
    __syncthreads();

    // floats [m, m + n) of `tile` go to out[first, first + n); `aligned`
    // is the float4 grid of both
    const int n = valid * C;
    float* aligned = a.out + (first - m);
    const int q0 = (m + 3) >> 2;
    const int q1 = (m + n) >> 2;
    for (int q = q0 + tid; q < q1; q += THREADS) {
      reinterpret_cast<float4*>(aligned)[q] = reinterpret_cast<const float4*>(tile)[q];
    }
    const int head_end = min(4 * q0, m + n);
    const int tail_begin = max(4 * q1, head_end);
    if (m + tid < head_end) aligned[m + tid] = tile[m + tid];
    if (tail_begin + tid < m + n) aligned[tail_begin + tid] = tile[tail_begin + tid];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The joint encode into the padded plane
// ---------------------------------------------------------------------------

struct JointArgs {
  const float* direct[MAX_JOINT_GROUPS];  // dense (height, width, 3)
  const float* indirect[MAX_JOINT_GROUPS];
  const float* albedo[MAX_JOINT_GROUPS];
  const float* normal;  // dense (height, width, 3) or null
  const float* depth;   // dense (height, width, 1) or null
  const float* alpha;   // dense (height, width, 1) or null
  float* out;           // dense (plane_h, plane_w, channels), 16-byte aligned
  long long npix;       // plane_h * plane_w
  int height, width;    // the frame
  int plane_w;
  int top, left;
  int groups, channels;
  int off_normal, off_depth, off_alpha;  // first channel of each aux pass within a pixel
  int reflect;          // 1: reflect (no edge repeat), 0: replicate
  float eps;
};

// The frame row or column that plane row or column o, `pad` past the
// frame's first, reads: PyTorch's reflection_pad2d (pad < n) or
// replication_pad2d.
__device__ __forceinline__ int source_of(int o, int pad, int n, bool reflect) {
  const int i = o - pad;
  if (reflect) {
    const int r = i < 0 ? -i : i;
    return r < n ? r : 2 * (n - 1) - r;
  }
  return min(max(i, 0), n - 1);
}

// One block per run of JOINT_PIXELS consecutive plane pixels (a run may
// span two plane rows). Thread t first finds plane pixel t's frame pixel;
// then lane t holds elements t, t + THREADS, t + 2 THREADS of the run's
// 3-channel passes (one 3-channel element each, 3 * JOINT_PIXELS in all)
// and pixel t of its 1-channel passes, loads every group's direct,
// indirect and albedo and the aux passes for them before it computes, and
// writes the encoded pixels into the run's tile in shared memory. The tile
// goes out with float4 stores.
template <bool NORMAL, bool DEPTH, bool ALPHA>
__global__ void __launch_bounds__(THREADS)
joint_encode_kernel(JointArgs a) {
  constexpr int K = JOINT_PIXELS * 3 / THREADS;  // 3-channel elements a lane
  static_assert(JOINT_PIXELS == THREADS && K * THREADS == JOINT_PIXELS * 3,
                "a pixel a lane, three 3-channel elements a lane");
  extern __shared__ __align__(16) float tile[];  // JOINT_PIXELS * channels
  __shared__ int src[JOINT_PIXELS];              // frame pixel of each plane pixel

  const int tid = threadIdx.x;
  const int C = a.channels;
  const long long p0 = static_cast<long long>(blockIdx.x) * JOINT_PIXELS;
  const long long rest = a.npix - p0;
  const int valid = rest < JOINT_PIXELS ? static_cast<int>(rest) : JOINT_PIXELS;
  const bool reflect = a.reflect != 0;
  if (tid < valid) {
    const long long p = p0 + tid;
    const int row = static_cast<int>(p / a.plane_w);
    const int col = static_cast<int>(p - static_cast<long long>(row) * a.plane_w);
    src[tid] = source_of(row, a.top, a.height, reflect) * a.width +
               source_of(col, a.left, a.width, reflect);
  }
  __syncthreads();

  long long at[K];  // this lane's elements in a 3-channel pass
  int px[K], ch[K];
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = tid + k * THREADS;
    px[k] = e / 3;
    ch[k] = e - 3 * px[k];
    ok[k] = px[k] < valid;
    at[k] = ok[k] ? static_cast<long long>(src[px[k]]) * 3 + ch[k] : 0;
  }

  // every load of the lane before its first use
  float d[MAX_JOINT_GROUPS][K], i[MAX_JOINT_GROUPS][K], c[MAX_JOINT_GROUPS][K];
#pragma unroll
  for (int g = 0; g < MAX_JOINT_GROUPS; ++g) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g < a.groups && ok[k]) {
        d[g][k] = a.direct[g][at[k]];
        i[g][k] = a.indirect[g][at[k]];
        c[g][k] = a.albedo[g][at[k]];
      }
    }
  }
  float nrm[K];
  if (NORMAL) {
#pragma unroll
    for (int k = 0; k < K; ++k) nrm[k] = ok[k] ? a.normal[at[k]] : 0.0f;
  }
  const bool own = tid < valid;
  const float dep = DEPTH && own ? a.depth[src[tid]] : 0.0f;
  const float alp = ALPHA && own ? a.alpha[src[tid]] : 0.0f;

  const RadianceOp radiance{a.eps};
#pragma unroll
  for (int g = 0; g < MAX_JOINT_GROUPS; ++g) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g < a.groups && ok[k]) {
        float* dst = tile + px[k] * C + 9 * g + ch[k];
        const float x[3] = {d[g][k], i[g][k], c[g][k]};
        float y[2];
        radiance.apply<true>(x, y);
        dst[0] = y[0];
        dst[3] = y[1];
        dst[6] = c[g][k];
      }
    }
  }
  if (NORMAL) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) NormalOp{}.apply<true>(&nrm[k], tile + px[k] * C + a.off_normal + ch[k]);
    }
  }
  if ((DEPTH || ALPHA) && own) {
    const float x[2] = {dep, alp};
    float y[2];
    DepthAlphaOp{}.apply<true>(x, y);
    if (DEPTH) tile[tid * C + a.off_depth] = y[0];
    if (ALPHA) tile[tid * C + a.off_alpha] = y[1];
  }
  __syncthreads();

  // the run is out[p0 * C, (p0 + valid) * C): p0 * C is a multiple of 4,
  // so the tile's float4s are the plane's
  const int n = valid * C;
  float* base = a.out + p0 * C;
  const int quads = n >> 2;
  for (int q = tid; q < quads; q += THREADS) {
    reinterpret_cast<float4*>(base)[q] = reinterpret_cast<const float4*>(tile)[q];
  }
  if (4 * quads + tid < n) base[4 * quads + tid] = tile[4 * quads + tid];
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError()
// after the launch (0 = launched). The caller checks shapes, types,
// contiguity and that outputs do not overlap.

// group_ptrs: 3 * groups device pointers in host memory, [direct, indirect,
// albedo] per group, each a dense 16-byte-aligned (npix, 3) tensor. normal
// (npix, 3), depth and alpha (npix, 1) are dense and aligned, or null where
// the aux set leaves them out; off_* is the pass's first channel within a
// pixel of C = 9 + aux channels. out: dense aligned (groups, npix, C).
extern "C" int fused_group_encode_f32(const float* const* group_ptrs, int groups,
                                      const float* normal, const float* depth, const float* alpha,
                                      float* out, long long npix,
                                      int off_normal, int off_depth, int off_alpha,
                                      float eps, void* stream) {
  if (groups < 1 || groups > MAX_GROUPS || npix < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int c = 9 + (normal ? 3 : 0) + (depth ? 1 : 0) + (alpha ? 1 : 0);
  if ((normal && (off_normal < 9 || off_normal + 3 > c)) || (depth && (off_depth < 9 || off_depth >= c)) ||
      (alpha && (off_alpha < 9 || off_alpha >= c))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (npix + TILE_PIXELS - 1) / TILE_PIXELS;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  GroupArgs a = {};
  for (int g = 0; g < groups; ++g) {
    a.direct[g] = group_ptrs[3 * g];
    a.indirect[g] = group_ptrs[3 * g + 1];
    a.albedo[g] = group_ptrs[3 * g + 2];
  }
  a.normal = normal;
  a.depth = depth;
  a.alpha = alpha;
  a.out = out;
  a.npix = npix;
  a.groups = groups;
  a.off_normal = off_normal;
  a.off_depth = off_depth;
  a.off_alpha = off_alpha;
  a.eps = eps;
  const unsigned int grid = static_cast<unsigned int>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((normal ? 4 : 0) | (depth ? 2 : 0) | (alpha ? 1 : 0)) {
    case 0: group_encode_kernel<false, false, false><<<grid, THREADS, 0, s>>>(a); break;
    case 1: group_encode_kernel<false, false, true><<<grid, THREADS, 0, s>>>(a); break;
    case 2: group_encode_kernel<false, true, false><<<grid, THREADS, 0, s>>>(a); break;
    case 3: group_encode_kernel<false, true, true><<<grid, THREADS, 0, s>>>(a); break;
    case 4: group_encode_kernel<true, false, false><<<grid, THREADS, 0, s>>>(a); break;
    case 5: group_encode_kernel<true, false, true><<<grid, THREADS, 0, s>>>(a); break;
    case 6: group_encode_kernel<true, true, false><<<grid, THREADS, 0, s>>>(a); break;
    default: group_encode_kernel<true, true, true><<<grid, THREADS, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// group_ptrs: 3 * groups device pointers in host memory, [direct, indirect,
// albedo] per group, each a dense (height, width, 3) tensor. normal
// (height, width, 3), depth and alpha (height, width, 1) are dense, or null
// where the aux set leaves them out; off_* is the pass's first channel
// within a pixel of C = 9 * groups + aux channels. out: dense, 16-byte
// aligned (top + height + bottom, left + width + right, C), the plane;
// reflect 1 mirrors the frame into the border without repeating its edge
// (each pad then smaller than its side), 0 repeats the edge pixel.
extern "C" int fused_joint_encode_f32(const float* const* group_ptrs, int groups,
                                      const float* normal, const float* depth, const float* alpha,
                                      float* out, int height, int width,
                                      int top, int bottom, int left, int right, int reflect,
                                      int off_normal, int off_depth, int off_alpha,
                                      float eps, void* stream) {
  if (groups < 1 || groups > MAX_JOINT_GROUPS || height < 1 || width < 1 || top < 0 ||
      bottom < 0 || left < 0 || right < 0 ||
      static_cast<long long>(height) * width > 0x7fffffffLL ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reflect && (top >= height || bottom >= height || left >= width || right >= width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int first_aux = 9 * groups;
  const int c = first_aux + (normal ? 3 : 0) + (depth ? 1 : 0) + (alpha ? 1 : 0);
  if ((normal && (off_normal < first_aux || off_normal + 3 > c)) ||
      (depth && (off_depth < first_aux || off_depth >= c)) ||
      (alpha && (off_alpha < first_aux || off_alpha >= c))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long plane_h = static_cast<long long>(top) + height + bottom;
  const long long plane_w = static_cast<long long>(left) + width + right;
  if (plane_h > 0x7fffffffLL || plane_w > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = plane_h * plane_w;
  const long long blocks = (npix + JOINT_PIXELS - 1) / JOINT_PIXELS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  JointArgs a = {};
  for (int g = 0; g < groups; ++g) {
    a.direct[g] = group_ptrs[3 * g];
    a.indirect[g] = group_ptrs[3 * g + 1];
    a.albedo[g] = group_ptrs[3 * g + 2];
  }
  a.normal = normal;
  a.depth = depth;
  a.alpha = alpha;
  a.out = out;
  a.npix = npix;
  a.height = height;
  a.width = width;
  a.plane_w = static_cast<int>(plane_w);
  a.top = top;
  a.left = left;
  a.groups = groups;
  a.channels = c;
  a.off_normal = off_normal;
  a.off_depth = off_depth;
  a.off_alpha = off_alpha;
  a.reflect = reflect;
  a.eps = eps;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const size_t smem = static_cast<size_t>(JOINT_PIXELS) * c * sizeof(float);  // at most 41 KB
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((normal ? 4 : 0) | (depth ? 2 : 0) | (alpha ? 1 : 0)) {
    case 0: joint_encode_kernel<false, false, false><<<grid, THREADS, smem, s>>>(a); break;
    case 1: joint_encode_kernel<false, false, true><<<grid, THREADS, smem, s>>>(a); break;
    case 2: joint_encode_kernel<false, true, false><<<grid, THREADS, smem, s>>>(a); break;
    case 3: joint_encode_kernel<false, true, true><<<grid, THREADS, smem, s>>>(a); break;
    case 4: joint_encode_kernel<true, false, false><<<grid, THREADS, smem, s>>>(a); break;
    case 5: joint_encode_kernel<true, false, true><<<grid, THREADS, smem, s>>>(a); break;
    case 6: joint_encode_kernel<true, true, false><<<grid, THREADS, smem, s>>>(a); break;
    default: joint_encode_kernel<true, true, true><<<grid, THREADS, smem, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The per-pass entry points: tensors are (npix, c) views with a pixel
// stride and a channel stride in elements.

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
