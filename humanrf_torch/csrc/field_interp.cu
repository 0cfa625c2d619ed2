// field_interp for Hopper (sm_90a): the 4D field's query, its table lookups
// with their corner math and the composition inside two kernels.
//
//     out[n, l*F + f] = sum_g  f_g[l, f](n) * v_{p(g)}[l*F + f](n),  p = (3, 2, 0, 1)
//
// where f_g is grid g's lookup at level l and v_p vector p's, read from the
// tables of the sample's own segment:
//
//     f_g[l, f](n) = sum_c  w_c(n) * grid_g[l, f, idx_c(n)]     (8 corners)
//     v_p[d](n)    = sum_k  w_k(n) * vectors[p, d, idx_k(n)]    (2 taps)
//
// Replaces the TPU kernels of humanrf_tpu/ops/fused_interp.py, the forward
// _fwd_kernel (:87) and the backward _bwd_kernel (:97), together with the
// corner math that humanrf_tpu/models/fused_field.py runs before each call
// (_grid_corner_idx_w, _vector_idx_w) and the composition after them. On the
// TPU, XLA fuses the corner math and the composition around the kernels. The
// plain version in PyTorch (humanrf_torch/ops/field_interp.py::
// field_query_plain) computes per segment a grid lookup and a vector lookup,
// each a (4, L*F, N) fp32 tensor over the whole budget, then their sum over
// segments and the composition's products and sums; in the backward the
// cotangents grad * v_p and grad * f_g, another (4, L*F, N) tensor each. Here
// each thread reads its sample's (x, y, z, t) as one float4, computes the
// corners in registers and writes only the (N, L*F) features.
//
// ---- The corner math --------------------------------------------------------
// Exactly the JAX package's arithmetic. Coordinates are clamped to [0, 1]
// first.
// - grid: grid g (xyz, xyt, yzt, xzt) reads the three axes of (x, y, z, t)
//   that it keeps (it drops t, z, x, y) at level l. scaled = x*scale + 0.5,
//   floor, frac; 8 corners (corner c has offset bit d = (c >> d) & 1 on axis
//   d); a dense level (res^3 <= T) indexes c0 + c1*res + c2*res^2, a hashed
//   one (c0*1 ^ c1*2654435761 ^ c2*805459861) mod T in uint32; the weight is
//   ((a*b)*c) of frac or 1 - frac per axis. A corner whose index is not in
//   [0, T) (a dense level's far corner when res^3 <= T < res^3 + res^2 + res)
//   contributes nothing and gets no gradient.
// - vector: vector p reads coordinate p; coord = x*R - 0.5; taps
//   clamp(floor, 0, R-1) and clamp(floor + 1, 0, R-1), weights 1 - frac and
//   frac.
// Every rounding step is written with __fmul_rn/__fadd_rn/__fsub_rn: nvcc
// would otherwise contract x*s + 0.5 into an fma, which can move floor across
// a cell boundary and change a corner. The forward also sums with separate
// roundings (no fma): each lookup corner by corner in order, as the plain
// version field_interp_plain sums it, then the composition in the order
// ((f0*v + f1*v) + f2*v) + f3*v, so the features equal the plain version's
// bit for bit.
//
// ---- Forward -----------------------------------------------------------------
// A thread per (sample, level), levels fastest, so that the L threads of a
// sample write its L*F features as one coalesced row. It computes the four
// grids' corners and lookups at its level and the partner vectors' taps in
// registers, then the products and their sum. It reads the tables where they
// lie, through L1 and L2 (__ldg): a thread needs the four grids of its level,
// which at the r4 width (4 x 32 KB per segment) do not fit beside other
// blocks in shared memory, and at the paper's T = 2^17 no table does. What
// bounds it: the gathers, 4 x 8 corners of F features and 4 x 2 taps per
// (sample, level), against an output of 4*L*F bytes a slot (128 B at
// L*F = 32), written once.
//
// ---- Backward ----------------------------------------------------------------
// A thread per (run of kBwdRun consecutive samples, level). For each grid g
// in turn it recomputes the sample's lookup f_g and the partner vector's v_p
// (nothing is kept from the forward), forms grad * v_p and grad * f_g in
// registers and adds w_c * grad * v_p into grid g's gradient and
// w_tap * grad * f_g into vector p's with global atomics. A corner's or tap's
// sum stays in registers while its index (and the segment) stays the same
// along the run, adding only when it changes: the consecutive samples of a
// ray share their coarse levels' corners and the time vector's taps, so most
// adds vanish there (an fp32 atomicAdd that collides with another retries).
// Atomics add in a run-dependent order; the sums are fp32.
//
// ---- Segments and skipped slots ----------------------------------------------
// `seg` (N,) int32 routes each sample to its segment; every segment's table
// pointers, table size and dense levels come in FieldQuery, passed by value
// (__grid_constant__: read in place, never copied per thread; up to 22.8 KB
// of parameters, which CUDA 12.1 and later take). A sample of no segment (seg
// outside [0, n_segments)), or at or past *n_valid (the empty tail of a
// static sample budget), writes zeros and adds nothing. Both inputs are read
// from device memory, so a launch needs no host read; one launch serves every
// segment, and its grid is sized by N, so a CUDA graph replays it unchanged.
//
// Both entry points launch on the caller's stream, allocate nothing, do not
// synchronise and return cudaGetLastError(). They take any N and T < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxLevels = 32;

// The limit on segments per launch: FieldQuery takes 88 B a segment, 22.8 KB
// in all at 256, under the 32 KB that a kernel's parameters may hold on
// Hopper. 256 holds any partitioning of 1000 frames (167 segments at the
// ladder's smallest, 6).
constexpr int kMaxSegments = 256;

// One segment's tables and, for the backward, the gradients it adds into.
struct SegmentTables {
  const float* grid[4];  // (L, F, T) each: xyz, xyt, yzt, xzt
  const float* vectors;  // (4, L*F, R)
  float* dgrid[4];       // backward: (L, F, T) each
  float* dvectors;       // backward: (4, L*F, R)
  uint32_t T;
  uint32_t dense;  // bit l: level l indexes densely (res^3 <= T)
};

// Passed by value (ctypes.Structure in humanrf_torch/ops/field_interp.py).
struct FieldQuery {
  int32_t n_segments;
  int32_t n_levels;  // L
  int32_t F;         // features per level, 1..8
  int32_t R;         // the vectors' resolution
  float scale[kMaxLevels];
  int32_t resolution[kMaxLevels];
  SegmentTables seg[kMaxSegments];
};

namespace {

constexpr int kThreads = 256;
// The backward's run length: the consecutive samples (along one ray) whose
// sums a thread keeps in registers.
constexpr int kBwdRun = 8;
constexpr uint32_t kOutside = 0xFFFFFFFFu;  // a corner outside [0, T)

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The corner math of one sample for one grid at one level, or for one
// vector, in registers.
struct PairSetup {
  int coord;      // grid: the dropped axis of (x, y, z, t); vector: the axis read
  float scale;    // grid: level scale; vector: R
  uint32_t res;   // grid: level resolution
  bool dense;
  uint32_t T;
  bool pow2;
};

__device__ __forceinline__ float component(const float4& q, int a) {
  return a == 0 ? q.x : a == 1 ? q.y : a == 2 ? q.z : q.w;
}

template <int kC>
__device__ __forceinline__ void corners(const PairSetup& s, const float4& q, uint32_t (&idx)[kC], float (&w)[kC]) {
  if constexpr (kC == 8) {
    // The three kept axes, in order.
    const float x0 = clamp01(s.coord == 0 ? q.y : q.x);
    const float x1 = clamp01(s.coord <= 1 ? q.z : q.y);
    const float x2 = clamp01(s.coord == 3 ? q.z : q.w);
    const float s0 = __fadd_rn(__fmul_rn(x0, s.scale), 0.5f);
    const float s1 = __fadd_rn(__fmul_rn(x1, s.scale), 0.5f);
    const float s2 = __fadd_rn(__fmul_rn(x2, s.scale), 0.5f);
    const float fl0 = floorf(s0), fl1 = floorf(s1), fl2 = floorf(s2);
    const float fr0 = __fsub_rn(s0, fl0), fr1 = __fsub_rn(s1, fl1), fr2 = __fsub_rn(s2, fl2);
    const float om0 = __fsub_rn(1.0f, fr0), om1 = __fsub_rn(1.0f, fr1), om2 = __fsub_rn(1.0f, fr2);
    const uint32_t b0 = static_cast<uint32_t>(static_cast<int>(fl0));
    const uint32_t b1 = static_cast<uint32_t>(static_cast<int>(fl1));
    const uint32_t b2 = static_cast<uint32_t>(static_cast<int>(fl2));
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t c0 = b0 + (c & 1), c1 = b1 + ((c >> 1) & 1), c2 = b2 + ((c >> 2) & 1);
      if (s.dense) {
        const uint64_t i = static_cast<uint64_t>(c0) + static_cast<uint64_t>(c1) * s.res +
                           static_cast<uint64_t>(c2) * s.res * s.res;
        idx[c] = i < s.T ? static_cast<uint32_t>(i) : kOutside;
      } else {
        const uint32_t h = c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u);
        idx[c] = s.pow2 ? (h & (s.T - 1)) : (h % s.T);
      }
      w[c] = __fmul_rn(__fmul_rn((c & 1) ? fr0 : om0, ((c >> 1) & 1) ? fr1 : om1), ((c >> 2) & 1) ? fr2 : om2);
    }
  } else {
    const float x = clamp01(component(q, s.coord));
    const float coord = __fsub_rn(__fmul_rn(x, s.scale), 0.5f);
    const float fl = floorf(coord);
    const float fr = __fsub_rn(coord, fl);
    const float top = static_cast<float>(s.T - 1);
    idx[0] = static_cast<uint32_t>(fminf(fmaxf(fl, 0.0f), top));
    idx[1] = static_cast<uint32_t>(fminf(fmaxf(__fadd_rn(fl, 1.0f), 0.0f), top));
    w[0] = __fsub_rn(1.0f, fr);
    w[1] = fr;
  }
}

// F rounded up to the kernels' template argument: 1, 2, 4 or 8.
int cover(int F) { return F <= 1 ? 1 : F <= 2 ? 2 : F <= 4 ? 4 : 8; }

// Blocks per SM that the backward must fit in registers: its run sums take
// ~100 registers a thread at F = 4.
constexpr int kQueryBwdMinBlocks = 2;

// The vector each grid is multiplied with, and the axis the grid drops:
// grids xyz, xyt, yzt, xzt pair with vectors t, z, x, y.
__device__ __forceinline__ int partner(int g) { return g == 0 ? 3 : g == 1 ? 2 : g == 2 ? 0 : 1; }

__device__ __forceinline__ PairSetup grid_pair(const FieldQuery& q, const SegmentTables& st, int g, int l) {
  PairSetup s;
  s.T = st.T;
  s.pow2 = (st.T & (st.T - 1)) == 0;
  s.coord = partner(g);
  s.scale = q.scale[l];
  s.res = static_cast<uint32_t>(q.resolution[l]);
  s.dense = ((st.dense >> l) & 1u) != 0;
  return s;
}

__device__ __forceinline__ PairSetup vector_pair(int p, uint32_t R) {
  PairSetup s;
  s.T = R;
  s.pow2 = (R & (R - 1)) == 0;
  s.coord = p;
  s.scale = static_cast<float>(R);
  s.res = R;
  s.dense = true;
  return s;
}

// The lookup of kC corners (or taps) of F <= kF features, feature k in the
// row at `row + k * stride`: summed corner by corner in order, each product
// and sum rounded on its own, as the plain version sums them.
template <int kC, int kF>
__device__ __forceinline__ void lookup(const float* row, int F, uint32_t stride, const uint32_t (&idx)[kC],
                                       const float (&w)[kC], float (&out)[kF]) {
#pragma unroll
  for (int k = 0; k < kF; ++k) out[k] = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (idx[c] == kOutside) continue;
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      if (k < F) out[k] = __fadd_rn(out[k], __fmul_rn(w[c], __ldg(row + static_cast<int64_t>(k) * stride + idx[c])));
    }
  }
}

// Adds one corner's (or tap's) run sum of F <= kF features at index t.
template <int kF>
__device__ __forceinline__ void add_run(float* row, int F, uint32_t stride, uint32_t t, const float (&sum)[kF]) {
  if (t == kOutside) return;
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    if (k < F) atomicAdd(row + static_cast<int64_t>(k) * stride + t, sum[k]);
  }
}

// The samples below *n_valid (all N without it).
__device__ __forceinline__ int64_t live_count(const int32_t* n_valid, int64_t N) {
  return n_valid == nullptr ? N : min(N, static_cast<int64_t>(max(__ldg(n_valid), 0)));
}

// The segment of sample n, or -1 for none (without seg, the one segment).
__device__ __forceinline__ int segment_of(const FieldQuery& q, const int32_t* seg, int64_t n) {
  if (seg == nullptr) return 0;
  const int s = __ldg(seg + n);
  return s >= 0 && s < q.n_segments ? s : -1;
}

// kF: F rounded up to 1, 2, 4 or 8.
template <int kF>
__global__ void __launch_bounds__(kThreads)
fused_field_fwd_kernel(const __grid_constant__ FieldQuery q, const float4* __restrict__ xyzt,
                       float* __restrict__ out,  // (N, L*F)
                       int64_t N, const int32_t* __restrict__ n_valid, const int32_t* __restrict__ seg) {
  const int L = q.n_levels, F = q.F, D = L * F;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= N * L) return;
  const int64_t n = t / L;
  const int l = static_cast<int>(t - n * L);
  float acc[kF];
#pragma unroll
  for (int k = 0; k < kF; ++k) acc[k] = 0.0f;
  const int s = n < live_count(n_valid, N) ? segment_of(q, seg, n) : -1;
  if (s >= 0) {
    const SegmentTables& st = q.seg[s];
    const float4 x = __ldg(xyzt + n);
    const uint32_t R = static_cast<uint32_t>(q.R);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int p = partner(g);
      uint32_t idx[8], vi[2];
      float w[8], vw[2], f[kF], v[kF];
      corners<8>(grid_pair(q, st, g, l), x, idx, w);
      lookup<8, kF>(st.grid[g] + static_cast<int64_t>(l) * F * st.T, F, st.T, idx, w, f);
      corners<2>(vector_pair(p, R), x, vi, vw);
      lookup<2, kF>(st.vectors + (static_cast<int64_t>(p) * D + l * F) * R, F, R, vi, vw, v);
#pragma unroll
      for (int k = 0; k < kF; ++k) {
        const float prod = __fmul_rn(f[k], v[k]);
        acc[k] = g == 0 ? prod : __fadd_rn(acc[k], prod);
      }
    }
  }
  float* dst = out + n * D + l * F;
  if (F == kF && kF == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  } else if (F == kF && kF >= 4) {
#pragma unroll
    for (int k = 0; k < kF; k += 4) {
      *reinterpret_cast<float4*>(dst + k) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      if (k < F) dst[k] = acc[k];
    }
  }
}

// kF as the forward's.
template <int kF>
__global__ void __launch_bounds__(kThreads, kQueryBwdMinBlocks)
fused_field_bwd_kernel(const __grid_constant__ FieldQuery q, const float4* __restrict__ xyzt,
                       const float* __restrict__ grad,  // (N, L*F)
                       int64_t N, const int32_t* __restrict__ n_valid, const int32_t* __restrict__ seg) {
  const int L = q.n_levels, F = q.F, D = L * F;
  const uint32_t R = static_cast<uint32_t>(q.R);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t runs = (N + kBwdRun - 1) / kBwdRun;
  if (t >= runs * L) return;
  const int64_t r = t / L;
  const int l = static_cast<int>(t - r * L);
  const int64_t n0 = r * kBwdRun;
  const int64_t live = live_count(n_valid, N);
  if (n0 >= live) return;
  const int len = static_cast<int>(min(static_cast<int64_t>(kBwdRun), live - n0));

  for (int g = 0; g < 4; ++g) {
    const int p = partner(g);
    uint32_t cur[8], vcur[2];
    float run[8][kF], vrun[2][kF];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      cur[c] = kOutside;
#pragma unroll
      for (int k = 0; k < kF; ++k) run[c][k] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      vcur[c] = kOutside;
#pragma unroll
      for (int k = 0; k < kF; ++k) vrun[c][k] = 0.0f;
    }
    int cur_s = -1;
    // Adds every open sum into segment cur_s's gradients; the next sample starts new runs.
    auto flush = [&]() {
      if (cur_s < 0) return;
      const SegmentTables& st = q.seg[cur_s];
      float* dg = st.dgrid[g] + static_cast<int64_t>(l) * F * st.T;
      float* dv = st.dvectors + (static_cast<int64_t>(p) * D + l * F) * R;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        add_run<kF>(dg, F, st.T, cur[c], run[c]);
        cur[c] = kOutside;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        add_run<kF>(dv, F, R, vcur[c], vrun[c]);
        vcur[c] = kOutside;
      }
    };
    for (int j = 0; j < len; ++j) {
      const int64_t n = n0 + j;
      const int s = segment_of(q, seg, n);
      if (s < 0) continue;
      if (s != cur_s) {
        flush();
        cur_s = s;
      }
      const SegmentTables& st = q.seg[s];
      const float4 x = __ldg(xyzt + n);
      const float* grow = grad + n * D + l * F;
      uint32_t idx[8], vi[2];
      float gr[kF], w[8], vw[2], f[kF], v[kF];
#pragma unroll
      for (int k = 0; k < kF; ++k) gr[k] = k < F ? __ldg(grow + k) : 0.0f;
      corners<8>(grid_pair(q, st, g, l), x, idx, w);
      lookup<8, kF>(st.grid[g] + static_cast<int64_t>(l) * F * st.T, F, st.T, idx, w, f);
      corners<2>(vector_pair(p, R), x, vi, vw);
      lookup<2, kF>(st.vectors + (static_cast<int64_t>(p) * D + l * F) * R, F, R, vi, vw, v);
      float* dg = st.dgrid[g] + static_cast<int64_t>(l) * F * st.T;
      float* dv = st.dvectors + (static_cast<int64_t>(p) * D + l * F) * R;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (idx[c] != cur[c]) {
          add_run<kF>(dg, F, st.T, cur[c], run[c]);
          cur[c] = idx[c];
#pragma unroll
          for (int k = 0; k < kF; ++k) run[c][k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kF; ++k) run[c][k] = fmaf(w[c], __fmul_rn(gr[k], v[k]), run[c][k]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (vi[c] != vcur[c]) {
          add_run<kF>(dv, F, R, vcur[c], vrun[c]);
          vcur[c] = vi[c];
#pragma unroll
          for (int k = 0; k < kF; ++k) vrun[c][k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kF; ++k) vrun[c][k] = fmaf(vw[c], __fmul_rn(gr[k], f[k]), vrun[c][k]);
      }
    }
    flush();
  }
}

bool valid_query(const FieldQuery& q, long long N) {
  if (q.n_segments < 1 || q.n_segments > kMaxSegments || q.n_levels < 1 || q.n_levels > kMaxLevels || q.F < 1 ||
      q.F > 8 || q.R < 1 || N < 0) {
    return false;
  }
  for (int s = 0; s < q.n_segments; ++s) {
    if (q.seg[s].T < 1 || q.seg[s].T >= (1u << 31)) return false;
  }
  return true;
}

unsigned query_blocks(int64_t threads) { return static_cast<unsigned>((threads + kThreads - 1) / kThreads); }

template <int kF>
cudaError_t launch_query_fwd(const FieldQuery& q, const float* xyzt, float* out, int64_t N, const int32_t* n_valid,
                             const int32_t* seg, cudaStream_t stream) {
  fused_field_fwd_kernel<kF><<<query_blocks(N * q.n_levels), kThreads, 0, stream>>>(
      q, reinterpret_cast<const float4*>(xyzt), out, N, n_valid, seg);
  return cudaGetLastError();
}

template <int kF>
cudaError_t launch_query_bwd(const FieldQuery& q, const float* xyzt, const float* grad, int64_t N,
                             const int32_t* n_valid, const int32_t* seg, cudaStream_t stream) {
  const int64_t runs = (N + kBwdRun - 1) / kBwdRun;
  fused_field_bwd_kernel<kF><<<query_blocks(runs * q.n_levels), kThreads, 0, stream>>>(
      q, reinterpret_cast<const float4*>(xyzt), grad, N, n_valid, seg);
  return cudaGetLastError();
}

}  // namespace

// The field query's forward: out (N, L*F) f32, every slot's features (0 for
// a skipped slot); xyzt (N, 4) f32, 16-byte aligned; q.seg[s].grid and
// .vectors the tables of segment s. n_valid (one int32) and seg ((N,)
// int32) may be null.
extern "C" int field_query_fwd(FieldQuery q, const float* xyzt, float* out, long long N, const int32_t* n_valid,
                               const int32_t* seg, void* stream) {
  if (!valid_query(q, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (cover(q.F)) {
    case 1: err = launch_query_fwd<1>(q, xyzt, out, N, n_valid, seg, st); break;
    case 2: err = launch_query_fwd<2>(q, xyzt, out, N, n_valid, seg, st); break;
    case 4: err = launch_query_fwd<4>(q, xyzt, out, N, n_valid, seg, st); break;
    case 8: err = launch_query_fwd<8>(q, xyzt, out, N, n_valid, seg, st); break;
  }
  return static_cast<int>(err);
}

// The field query's backward: grad (N, L*F) f32, the features' cotangent;
// it adds each table's and vector's gradient into q.seg[s].dgrid and
// .dvectors, contiguous f32 buffers shaped as the tables (fp32 atomics only:
// zeros give the gradient itself; a table's zeroed or accumulating .grad
// takes it as .grad += would). The rest as the forward's.
extern "C" int field_query_bwd(FieldQuery q, const float* xyzt, const float* grad, long long N,
                               const int32_t* n_valid, const int32_t* seg, void* stream) {
  if (!valid_query(q, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (cover(q.F)) {
    case 1: err = launch_query_bwd<1>(q, xyzt, grad, N, n_valid, seg, st); break;
    case 2: err = launch_query_bwd<2>(q, xyzt, grad, N, n_valid, seg, st); break;
    case 4: err = launch_query_bwd<4>(q, xyzt, grad, N, n_valid, seg, st); break;
    case 8: err = launch_query_bwd<8>(q, xyzt, grad, N, n_valid, seg, st); break;
  }
  return static_cast<int>(err);
}
