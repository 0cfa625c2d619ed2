// kplanes for Hopper (sm_90a): the K-Planes field's query, every scale's six
// plane lookups and their product, in one kernel each way; and its plane
// regularisers over every plane of the field and its proposals.
//
//     out[n, s*M + m] = prod_{p in planes}  bilinear(P_p^s, pi_p(q_n))[m]
//
// q_n = (x, y, z, t) in [-1, 1]^4; the planes p are the axis pairs (i, j)
// of itertools.combinations(range(4), 2): xy, xz, xt, yz, yt, zt. Plane
// (i, j) at scale s is a (res_j, res_i, M) float32 tensor, channels last:
// texel (row, col) holds M consecutive channels, row along axis j and col
// along axis i.
//
// ---- The lookup --------------------------------------------------------------
// F.grid_sample's bilinear sampling with align_corners=True and border
// padding: along an axis of size R, pix = ((c + 1) * 0.5) * (R - 1), clamped
// to [0, R - 1]; taps floor(pix) and min(floor(pix) + 1, R - 1), weights
// 1 - frac and frac. A plane's value sums its four taps in the order
// (row0, col0), (row0, col1), (row1, col0), (row1, col1), each weight the
// product (1 - fu or fu) * (1 - fv or fv), then the six planes multiply in
// order. Every product and sum is rounded on its own (__fmul_rn/__fadd_rn:
// no fma), as the plain version in PyTorch (humanrf_torch/ops/kplanes.py::
// plane_query_plain) computes them, so the features equal its bit for bit.
//
// ---- Forward -----------------------------------------------------------------
// A thread per (sample, scale, run of 4 channels), channels fastest: the
// M/4 threads of a (sample, scale) read each tap's M channels as one
// coalesced row (128 B at M = 32, 32 B at M = 8) and write their features as
// one row. Each computes the taps of its scale's four axes in registers. The
// planes are read where they lie, through L1 and L2 (__ldg): the finest
// scale's spatial planes are 33.5 MB each at M = 32, more than the L2. What
// bounds it: 6 planes x 4 taps of M channels a (sample, scale), gathers.
//
// ---- Backward ----------------------------------------------------------------
// A thread per (run of kBwdRun consecutive samples, scale, 4 channels). For
// each sample it recomputes the six plane values (nothing is kept from the
// forward), forms d value_p = grad * prod_{q != p} value_q, and adds
// w_tap * d value_p into each of plane p's four taps. A tap's sum stays in
// registers while its texel stays the same along the run and is added with
// one 16-byte atomic when it changes: the consecutive samples of a ray share
// the coarse scales' texels and, in the time planes, the frame's row, so
// most adds vanish there. Atomics add in a run-dependent order; the sums are
// fp32.
//
// ---- Skipped slots -----------------------------------------------------------
// A sample at or past *n_valid, or whose seg is negative, writes zeros and
// adds nothing. Both inputs are read from device memory, so a launch needs
// no host read and a CUDA graph replays it unchanged.
//
// The query's two entry points and the regularisers' two (below) launch on
// the caller's stream, allocate nothing, do not synchronise and return
// cudaGetLastError(). The query's instances: M in {8, 32}, scales in {1, 4}.
//
// ---- The plane regularisers ------------------------------------------------------
// The weighted regularisers of every plane of the field and its proposals,
// one scalar, and its gradient: on a spatial plane (h, w, M) plane TV,
//     w0 * sum (P[r+1, c] - P[r, c])^2  +  w1 * sum (P[r, c+1] - P[r, c])^2,
// on a time plane (rows along t) smoothness and the L1 distance from 1,
//     w0 * sum ((P[k] - P[k-1]) - (P[k-1] - P[k-2]))^2  +  w1 * sum |1 - P|,
// each weight its term's weight over the term's count (the plain version's
// means: models/kplanes.py::plane_tv, time_smoothness). No TPU kernel is
// replaced: K-Planes exists only in the port; this takes the place of the
// ~40 PyTorch passes (differences, squares, means, their slice-backward
// copies and the adds into .grad) that autograd makes over each plane.
// What bounds it: bytes. 4 B an entry forward (one read), 12 B backward
// (one read of the plane, a read and a write of its gradient): 16 B an
// entry, 607 MB and ~0.18 ms at 3.35 TB/s over K-Planes' 37.9 M entries.
// The design reads each entry once each way and writes no temporaries: a
// thread takes one float4 of a row (4 channels of a texel) and marches
// down a strip of kRegStrip rows, holding the rows it needs before and
// after in registers; the column neighbour (the next texel's same
// channels) is another thread's float4 of the same row, read again through
// L1. A strip re-reads the one row above it (two on a time plane, and one
// or two below it backward). The forward writes one partial a block
// (fp64); a second one-block launch sums them in a fixed order: no float
// atomics, so the scalar repeats bit for bit. The backward reads the
// scalar's cotangent from device memory (a CUDA graph replays it as it
// is), computes each entry's analytic gradient with every product and sum
// rounded on its own (the plain mirror, ops/kplanes.py::
// plane_reg_bwd_plain, equals it bit for bit) and adds it into the
// plane's .grad, or writes it into a fresh buffer.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxScales = 4;
constexpr int kPlanes = 6;

// Passed by value (ctypes.Structure in humanrf_torch/ops/kplanes.py).
struct PlaneQuery {
  int32_t n_scales;
  int32_t M;                         // channels a plane, 8 or 32
  int32_t res[kMaxScales][4];        // per scale the size along x, y, z, t
  const float* plane[kMaxScales][kPlanes];  // (res_j, res_i, M) each
  float* dplane[kMaxScales][kPlanes];       // backward: shaped as the planes
};

namespace {

constexpr int kThreads = 256;
constexpr int kBwdThreads = 128;
// Two blocks a multiprocessor: this lets the compiler keep the run sums in
// registers (255 a thread) at one scale too, where without it the sums
// spill to local memory and the backward takes ~13x longer on the card.
constexpr int kBwdMinBlocks = 2;
// The backward's run length: the consecutive samples (along one ray) whose
// sums a thread keeps in registers.
constexpr int kBwdRun = 8;
constexpr uint32_t kNone = 0xFFFFFFFFu;

// Plane p's two axes, (i, j): combinations(range(4), 2).
__device__ __forceinline__ int axis_i(int p) { return p < 3 ? 0 : p < 5 ? 1 : 2; }
__device__ __forceinline__ int axis_j(int p) { return p == 0 ? 1 : p == 1 ? 2 : p == 2 ? 3 : p == 3 ? 2 : 3; }

__device__ __forceinline__ float component(const float4& q, int a) {
  return a == 0 ? q.x : a == 1 ? q.y : a == 2 ? q.z : q.w;
}

struct Tap {
  uint32_t i0, i1;
  float fr, om;  // frac and 1 - frac
};

__device__ __forceinline__ Tap tap(float c, int size) {
  const float top = static_cast<float>(size - 1);
  float pix = __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), top);
  pix = fminf(fmaxf(pix, 0.0f), top);
  const float fl = floorf(pix);
  Tap t;
  t.i0 = static_cast<uint32_t>(fl);
  t.i1 = min(t.i0 + 1u, static_cast<uint32_t>(size - 1));
  t.fr = __fsub_rn(pix, fl);
  t.om = __fsub_rn(1.0f, t.fr);
  return t;
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 scale4(float w, const float4& a) {
  return make_float4(__fmul_rn(w, a.x), __fmul_rn(w, a.y), __fmul_rn(w, a.z), __fmul_rn(w, a.w));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 fma4(float w, const float4& a, const float4& acc) {
  return make_float4(fmaf(w, a.x, acc.x), fmaf(w, a.y, acc.y), fmaf(w, a.z, acc.z), fmaf(w, a.w, acc.w));
}

// One plane's four taps at a sample: texel indices (row * W + col) in tap
// order and their weights.
struct Corners {
  uint32_t idx[4];
  float w[4];
};

__device__ __forceinline__ Corners corners(const Tap& u, const Tap& v, uint32_t W) {
  Corners c;
  c.idx[0] = v.i0 * W + u.i0;
  c.idx[1] = v.i0 * W + u.i1;
  c.idx[2] = v.i1 * W + u.i0;
  c.idx[3] = v.i1 * W + u.i1;
  c.w[0] = __fmul_rn(u.om, v.om);
  c.w[1] = __fmul_rn(u.fr, v.om);
  c.w[2] = __fmul_rn(u.om, v.fr);
  c.w[3] = __fmul_rn(u.fr, v.fr);
  return c;
}

// The plane's value for channels [4c, 4c + 4): its taps summed in order.
template <int kC>
__device__ __forceinline__ float4 lookup(const float4* plane, const Corners& k, int c) {
  float4 v = scale4(k.w[0], __ldg(plane + static_cast<int64_t>(k.idx[0]) * kC + c));
#pragma unroll
  for (int t = 1; t < 4; ++t) v = add4(v, scale4(k.w[t], __ldg(plane + static_cast<int64_t>(k.idx[t]) * kC + c)));
  return v;
}

__device__ __forceinline__ void add_texel(float4* dst, const float4& v) {
#if __CUDA_ARCH__ >= 900
  atomicAdd(dst, v);  // one 16-byte reduction (sm_90)
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d, v.x);
  atomicAdd(d + 1, v.y);
  atomicAdd(d + 2, v.z);
  atomicAdd(d + 3, v.w);
#endif
}

// Whether sample n is served: below *n_valid and of no negative seg.
__device__ __forceinline__ bool served(int64_t n, const int32_t* n_valid, const int32_t* seg) {
  if (n_valid != nullptr && n >= static_cast<int64_t>(__ldg(n_valid))) return false;
  return seg == nullptr || __ldg(seg + n) >= 0;
}

template <int kM, int kS>
__global__ void __launch_bounds__(kThreads)
kplanes_fwd_kernel(const __grid_constant__ PlaneQuery q, const float4* __restrict__ coords,
                   float4* __restrict__ out,  // (N, kS*kM)
                   int64_t N, const int32_t* __restrict__ n_valid, const int32_t* __restrict__ seg) {
  constexpr int kC = kM / 4;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= N * kS * kC) return;
  const int64_t n = t / (kS * kC);
  const int r = static_cast<int>(t - n * (kS * kC));
  const int s = r / kC, c = r - s * kC;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (served(n, n_valid, seg)) {
    const float4 x = __ldg(coords + n);
    Tap taps[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) taps[a] = tap(component(x, a), q.res[s][a]);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const int i = axis_i(p), j = axis_j(p);
      const Corners k = corners(taps[i], taps[j], static_cast<uint32_t>(q.res[s][i]));
      const float4 v = lookup<kC>(reinterpret_cast<const float4*>(q.plane[s][p]), k, c);
      acc = p == 0 ? v : mul4(acc, v);
    }
  }
  out[t] = acc;
}

template <int kM, int kS>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
kplanes_bwd_kernel(const __grid_constant__ PlaneQuery q, const float4* __restrict__ coords,
                   const float4* __restrict__ grad,  // (N, kS*kM)
                   int64_t N, const int32_t* __restrict__ n_valid, const int32_t* __restrict__ seg) {
  constexpr int kC = kM / 4;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x;
  const int64_t runs = (N + kBwdRun - 1) / kBwdRun;
  if (t >= runs * kS * kC) return;
  const int64_t run = t / (kS * kC);
  const int r = static_cast<int>(t - run * (kS * kC));
  const int s = kS == 1 ? 0 : r / kC, c = kS == 1 ? r : r - (r / kC) * kC;
  const int64_t n0 = run * kBwdRun;
  const int len = static_cast<int>(min(static_cast<int64_t>(kBwdRun), N - n0));

  uint32_t cur[kPlanes][4];
  float4 sum[kPlanes][4];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cur[p][k] = kNone;
      sum[p][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
#pragma unroll 1
  for (int jn = 0; jn < len; ++jn) {
    const int64_t n = n0 + jn;
    if (!served(n, n_valid, seg)) continue;
    const float4 x = __ldg(coords + n);
    const float4 g = __ldg(grad + n * (kS * kC) + s * kC + c);
    Tap taps[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) taps[a] = tap(component(x, a), q.res[s][a]);
    Corners k[kPlanes];
    float4 v[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const int i = axis_i(p), j = axis_j(p);
      k[p] = corners(taps[i], taps[j], static_cast<uint32_t>(q.res[s][i]));
      v[p] = lookup<kC>(reinterpret_cast<const float4*>(q.plane[s][p]), k[p], c);
    }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      float4 d = g;
#pragma unroll
      for (int o = 0; o < kPlanes; ++o) {
        if (o != p) d = mul4(d, v[o]);
      }
      float4* dst = reinterpret_cast<float4*>(q.dplane[s][p]);
#pragma unroll
      for (int tk = 0; tk < 4; ++tk) {
        if (k[p].idx[tk] != cur[p][tk]) {
          if (cur[p][tk] != kNone) add_texel(dst + static_cast<int64_t>(cur[p][tk]) * kC + c, sum[p][tk]);
          cur[p][tk] = k[p].idx[tk];
          sum[p][tk] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        sum[p][tk] = fma4(k[p].w[tk], d, sum[p][tk]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    float4* dst = reinterpret_cast<float4*>(q.dplane[s][p]);
#pragma unroll
    for (int tk = 0; tk < 4; ++tk) {
      if (cur[p][tk] != kNone) add_texel(dst + static_cast<int64_t>(cur[p][tk]) * kC + c, sum[p][tk]);
    }
  }
}

bool valid_query(const PlaneQuery& q, long long N) {
  if ((q.n_scales != 1 && q.n_scales != 4) || (q.M != 8 && q.M != 32) || N < 0) return false;
  for (int s = 0; s < q.n_scales; ++s) {
    for (int a = 0; a < 4; ++a) {
      if (q.res[s][a] < 2 || q.res[s][a] > (1 << 15)) return false;
    }
  }
  return true;
}

unsigned blocks(int64_t threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

template <int kM, int kS>
cudaError_t launch_fwd(const PlaneQuery& q, const float* coords, float* out, int64_t N, const int32_t* n_valid,
                       const int32_t* seg, cudaStream_t stream) {
  kplanes_fwd_kernel<kM, kS><<<blocks(N * kS * (kM / 4), kThreads), kThreads, 0, stream>>>(
      q, reinterpret_cast<const float4*>(coords), reinterpret_cast<float4*>(out), N, n_valid, seg);
  return cudaGetLastError();
}

template <int kM, int kS>
cudaError_t launch_bwd(const PlaneQuery& q, const float* coords, const float* grad, int64_t N,
                       const int32_t* n_valid, const int32_t* seg, cudaStream_t stream) {
  const int64_t runs = (N + kBwdRun - 1) / kBwdRun;
  kplanes_bwd_kernel<kM, kS><<<blocks(runs * kS * (kM / 4), kBwdThreads), kBwdThreads, 0, stream>>>(
      q, reinterpret_cast<const float4*>(coords), reinterpret_cast<const float4*>(grad), N, n_valid, seg);
  return cudaGetLastError();
}

}  // namespace

// The query's forward: out (N, S*M) f32, every slot's features (0 for a
// skipped slot); coords (N, 4) f32 in [-1, 1], 16-byte aligned; out 16-byte
// aligned. n_valid (one int32) and seg ((N,) int32) may be null.
extern "C" int kplanes_fwd(PlaneQuery q, const float* coords, float* out, long long N, const int32_t* n_valid,
                           const int32_t* seg, void* stream) {
  if (!valid_query(q, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = q.M == 32, multi = q.n_scales == 4;
  cudaError_t err;
  if (wide) {
    err = multi ? launch_fwd<32, 4>(q, coords, out, N, n_valid, seg, st)
                : launch_fwd<32, 1>(q, coords, out, N, n_valid, seg, st);
  } else {
    err = multi ? launch_fwd<8, 4>(q, coords, out, N, n_valid, seg, st)
                : launch_fwd<8, 1>(q, coords, out, N, n_valid, seg, st);
  }
  return static_cast<int>(err);
}

// The query's backward: grad (N, S*M) f32, the features' cotangent, 16-byte
// aligned; it adds each plane's gradient into q.dplane, contiguous f32
// buffers shaped as the planes (fp32 atomics only: zeros give the gradient
// itself; a plane's zeroed or accumulating .grad takes it as .grad += would).
// The rest as the forward's.
extern "C" int kplanes_bwd(PlaneQuery q, const float* coords, const float* grad, long long N,
                           const int32_t* n_valid, const int32_t* seg, void* stream) {
  if (!valid_query(q, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = q.M == 32, multi = q.n_scales == 4;
  cudaError_t err;
  if (wide) {
    err = multi ? launch_bwd<32, 4>(q, coords, grad, N, n_valid, seg, st)
                : launch_bwd<32, 1>(q, coords, grad, N, n_valid, seg, st);
  } else {
    err = multi ? launch_bwd<8, 4>(q, coords, grad, N, n_valid, seg, st)
                : launch_bwd<8, 1>(q, coords, grad, N, n_valid, seg, st);
  }
  return static_cast<int>(err);
}

// ---- The plane regularisers ------------------------------------------------------

constexpr int kMaxRegPlanes = 64;
constexpr int32_t kSpatial = 0, kTime = 1;

struct RegPlane {
  const float* plane;  // (h, w, M) float32, contiguous, 16-byte aligned
  float* grad;         // backward: shaped as the plane
  int32_t h;           // rows
  int32_t row4;        // float4s a row: w * M / 4
  int32_t m4;          // float4s a texel: M / 4
  int32_t kind;        // kSpatial or kTime
  int32_t block0;      // the plane's first block
  int32_t accumulate;  // backward: 1 adds into grad, 0 writes it
  double w0, w1;       // kSpatial: the row and the column weight; kTime: smoothness and L1
};

// Passed by value (ctypes.Structure in humanrf_torch/ops/kplanes.py).
struct PlaneReg {
  int32_t n_planes;
  int32_t n_blocks;
  RegPlane p[kMaxRegPlanes];
};

namespace {

constexpr int kRegThreads = 256;
constexpr int kRegStrip = 32;  // the rows a thread marches down

__host__ __device__ __forceinline__ int64_t reg_strips(int32_t h) { return (h + kRegStrip - 1) / kRegStrip; }

// The plane of block b: block0 rises with the plane's index.
__device__ __forceinline__ int reg_plane_of(const PlaneReg& r, int b) {
  int p = 0;
  while (p + 1 < r.n_planes && r.p[p + 1].block0 <= b) ++p;
  return p;
}

__device__ __forceinline__ float4 sub4(const float4& a, const float4& b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ float sumsq4(const float4& d) {
  return d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
}

__device__ __forceinline__ float sign1(float v) {  // sign(v - 1), 0 at 1
  return static_cast<float>(v > 1.0f) - static_cast<float>(v < 1.0f);
}

// c0 * a + c1 * b, each product and the sum rounded on its own.
__device__ __forceinline__ float4 combine4(float c0, const float4& a, float c1, const float4& b) {
  return add4(scale4(c0, a), scale4(c1, b));
}

// A thread's place: its plane, the float4 e of the row, the strip's rows [r0, r1).
struct RegSlot {
  int p;
  int e, r0, r1;
  bool live;
};

__device__ __forceinline__ RegSlot reg_slot(const PlaneReg& r) {
  RegSlot s;
  s.p = reg_plane_of(r, blockIdx.x);
  const RegPlane& pl = r.p[s.p];
  const int64_t t = (static_cast<int64_t>(blockIdx.x) - pl.block0) * kRegThreads + threadIdx.x;
  const int64_t strip = t / pl.row4;
  s.e = static_cast<int>(t - strip * pl.row4);
  s.r0 = static_cast<int>(strip) * kRegStrip;
  s.r1 = min(s.r0 + kRegStrip, pl.h);
  s.live = strip < reg_strips(pl.h);
  return s;
}

// Sums v over the block in a fixed order; the result in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warps[kRegThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kRegThreads / 32 ? warps[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kRegThreads)
plane_reg_fwd_kernel(const __grid_constant__ PlaneReg r, double* __restrict__ partial) {
  const RegSlot s = reg_slot(r);
  const RegPlane& pl = r.p[s.p];
  double v = 0.0;
  if (s.live) {
    const float4* P = reinterpret_cast<const float4*>(pl.plane);
    const int64_t row4 = pl.row4;
    int64_t at = s.r0 * row4 + s.e;
    float a = 0.0f, b = 0.0f;
    if (pl.kind == kSpatial) {
      const bool right = s.e + pl.m4 < pl.row4;
      float4 prev = s.r0 > 0 ? __ldg(P + at - row4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int row = s.r0; row < s.r1; ++row, at += row4) {
        const float4 x = __ldg(P + at);
        if (row > 0) a += sumsq4(sub4(x, prev));
        if (right) b += sumsq4(sub4(__ldg(P + at + pl.m4), x));
        prev = x;
      }
    } else {
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 p2 = s.r0 > 1 ? __ldg(P + at - 2 * row4) : zero, p1 = s.r0 > 0 ? __ldg(P + at - row4) : zero;
#pragma unroll 4
      for (int row = s.r0; row < s.r1; ++row, at += row4) {
        const float4 x = __ldg(P + at);
        if (row > 1) a += sumsq4(sub4(sub4(x, p1), sub4(p1, p2)));
        b += fabsf(1.0f - x.x) + fabsf(1.0f - x.y) + fabsf(1.0f - x.z) + fabsf(1.0f - x.w);
        p2 = p1;
        p1 = x;
      }
    }
    v = pl.w0 * static_cast<double>(a) + pl.w1 * static_cast<double>(b);
  }
  v = block_sum(v);
  if (threadIdx.x == 0) partial[blockIdx.x] = v;
}

__global__ void __launch_bounds__(kRegThreads)
plane_reg_sum_kernel(const double* __restrict__ partial, int n, float* __restrict__ out) {
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kRegThreads) v += partial[i];
  v = block_sum(v);
  if (threadIdx.x == 0) *out = static_cast<float>(v);
}

__global__ void __launch_bounds__(kRegThreads)
plane_reg_bwd_kernel(const __grid_constant__ PlaneReg r, const float* __restrict__ cotangent) {
  const RegSlot s = reg_slot(r);
  if (!s.live) return;
  const RegPlane& pl = r.p[s.p];
  const float g = __ldg(cotangent);
  const float4* P = reinterpret_cast<const float4*>(pl.plane);
  float4* G = reinterpret_cast<float4*>(pl.grad);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int64_t row4 = pl.row4;
  const int h = pl.h;
  int64_t at = s.r0 * row4 + s.e;
  if (pl.kind == kSpatial) {
    // d/dP[r] of the row term: 2 w0 ((P[r] - P[r-1]) - (P[r+1] - P[r])), a
    // side left out at the edges; the columns' the same along the row.
    const float c0 = __fmul_rn(g, static_cast<float>(2.0 * pl.w0));
    const float c1 = __fmul_rn(g, static_cast<float>(2.0 * pl.w1));
    const bool left = s.e >= pl.m4, right = s.e + pl.m4 < pl.row4;
    float4 up = s.r0 > 0 ? __ldg(P + at - row4) : zero;
    float4 x = __ldg(P + at);
#pragma unroll 2
    for (int row = s.r0; row < s.r1; ++row, at += row4) {
      const float4 down = row + 1 < h ? __ldg(P + at + row4) : zero;
      const float4 gr = sub4(row > 0 ? sub4(x, up) : zero, row + 1 < h ? sub4(down, x) : zero);
      const float4 gc = sub4(left ? sub4(x, __ldg(P + at - pl.m4)) : zero,
                             right ? sub4(__ldg(P + at + pl.m4), x) : zero);
      const float4 d = combine4(c0, gr, c1, gc);
      G[at] = pl.accumulate ? add4(G[at], d) : d;
      up = x;
      x = down;
    }
  } else {
    // With s_k = (P[k] - P[k-1]) - (P[k-1] - P[k-2]) for k in [2, h):
    // d/dP[r] = 2 w0 (s_r - 2 s_{r+1} + s_{r+2}) + w1 sign(P[r] - 1), each
    // s that does not exist left out.
    const float c0 = __fmul_rn(g, static_cast<float>(2.0 * pl.w0));
    const float c1 = __fmul_rn(g, static_cast<float>(pl.w1));
    float4 q[5];  // P[row - 2 .. row + 2]
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int row = s.r0 - 2 + k;
      q[k] = row >= 0 && row < h ? __ldg(P + at + (k - 2) * row4) : zero;
    }
#pragma unroll 1
    for (int row = s.r0; row < s.r1; ++row, at += row4) {
      const float4 sr = row >= 2 ? sub4(sub4(q[2], q[1]), sub4(q[1], q[0])) : zero;
      const float4 s1 = row >= 1 && row + 1 < h ? sub4(sub4(q[3], q[2]), sub4(q[2], q[1])) : zero;
      const float4 s2 = row + 2 < h ? sub4(sub4(q[4], q[3]), sub4(q[3], q[2])) : zero;
      const float4 gs = add4(sub4(sr, scale4(2.0f, s1)), s2);
      const float4 l1 = make_float4(sign1(q[2].x), sign1(q[2].y), sign1(q[2].z), sign1(q[2].w));
      const float4 d = combine4(c0, gs, c1, l1);
      G[at] = pl.accumulate ? add4(G[at], d) : d;
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = q[k + 1];
      q[4] = row + 3 < h ? __ldg(P + at + 3 * row4) : zero;
    }
  }
}

// The table's planes are well formed and its blocks laid out as the wrapper
// lays them: each plane ceil(row4 * strips / kRegThreads) blocks, in order.
bool valid_reg(const PlaneReg& r, bool backward) {
  if (r.n_planes < 1 || r.n_planes > kMaxRegPlanes) return false;
  int64_t block = 0;
  for (int p = 0; p < r.n_planes; ++p) {
    const RegPlane& pl = r.p[p];
    if (pl.plane == nullptr || (backward && pl.grad == nullptr)) return false;
    if (pl.kind != kSpatial && pl.kind != kTime) return false;
    const bool time = pl.kind == kTime;
    if (pl.h < (time ? 3 : 2) || pl.m4 < 1 || pl.row4 < (time ? 1 : 2) * pl.m4 || pl.row4 % pl.m4 != 0) return false;
    if (pl.block0 != block) return false;
    block += blocks(pl.row4 * reg_strips(pl.h), kRegThreads);
  }
  return block == r.n_blocks && block < (int64_t{1} << 31);
}

}  // namespace

// The regularisers' forward: *out (float32) = the weighted sum over every
// plane of the table; partial: r.n_blocks doubles of scratch. Two launches.
extern "C" int plane_reg_fwd(PlaneReg r, double* partial, float* out, void* stream) {
  if (!valid_reg(r, false)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  plane_reg_fwd_kernel<<<r.n_blocks, kRegThreads, 0, st>>>(r, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_reg_sum_kernel<<<1, kRegThreads, 0, st>>>(partial, r.n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// The regularisers' backward: each plane's gradient times *cotangent (one
// float32 on the device) added into r.p[i].grad where accumulate is 1,
// else written there. One launch.
extern "C" int plane_reg_bwd(PlaneReg r, const float* cotangent, void* stream) {
  if (!valid_reg(r, true)) return static_cast<int>(cudaErrorInvalidValue);
  plane_reg_bwd_kernel<<<r.n_blocks, kRegThreads, 0, static_cast<cudaStream_t>(stream)>>>(r, cotangent);
  return static_cast<int>(cudaGetLastError());
}
