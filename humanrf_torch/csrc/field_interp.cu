// field_interp for Hopper (sm_90a): the 4D field's table lookups with their
// corner math inside the kernels.
//
//     out[p, f, n]  = sum_c  w_c(p, xyzt[n]) * tables[p, f, idx_c(p, xyzt[n])]        (forward)
//     dtab[p, f, t] = sum_{n, c} g[p, f, n] * w_c(p, xyzt[n]) * [idx_c(p, xyzt[n]) == t] (backward)
//
// Two pairs of entry points. The per-pair kernels (field_interp_fwd/_bwd)
// look up one mode, the grids or the vectors, of one segment, and write
// every (pair, feature, sample). The field query (field_query_fwd/_bwd,
// "The field query" below) is the main path: one launch each way for a
// whole query over every segment and both modes, with the 4D composition
// inside. The notes that follow are the per-pair kernels'; the query reuses
// their corner math.
//
// Replaces the TPU kernels of humanrf_tpu/ops/fused_interp.py, the forward
// _fwd_kernel (:87) and the backward _bwd_kernel (:97), together with the
// corner math that humanrf_tpu/models/fused_field.py runs before each call
// (_grid_corner_idx_w, _vector_idx_w). On the TPU, XLA fuses that corner math
// into one program; in eager PyTorch it was ~5,000 small launches per field
// query and 8 B per corner and sample of (idx, w) through HBM. Here each
// thread reads its sample's (x, y, z, t) as one float4 and computes the
// corners in registers.
//
// Two modes (FieldSpec.mode), exactly the JAX package's arithmetic:
// - grid: tables (4L, F, T); pair p = g*L + l reads grid g's axes (xyz, xyt,
//   yzt, xzt) at level l. scaled = x*scale + 0.5, floor, frac; 8 corners
//   (corner c has offset bit d = (c >> d) & 1 on axis d); a dense level
//   (res^3 <= T) indexes c0 + c1*res + c2*res^2, a hashed one
//   (c0*1 ^ c1*2654435761 ^ c2*805459861) mod T in uint32; the weight is
//   ((a*b)*c) of frac or 1 - frac per axis. A corner whose index is not in
//   [0, T) (a dense level's far corner when res^3 <= T < res^3 + res^2 + res)
//   contributes nothing and gets no gradient.
// - vector: tables (4, D, R); pair p reads coordinate p; coord = x*R - 0.5;
//   taps clamp(floor, 0, R-1) and clamp(floor + 1, 0, R-1), weights 1 - frac
//   and frac.
// Coordinates are clamped to [0, 1] first. Every rounding step is written
// with __fmul_rn/__fadd_rn/__fsub_rn: nvcc would otherwise contract x*s + 0.5
// into an fma, which can move floor across a cell boundary and change a
// corner. The forward also sums with separate roundings (no fma), corner by
// corner in order, so it equals the plain PyTorch version bit for bit.
//
// ---- What bounds them on an H100 --------------------------------------------
// Forward at the r4 grid shape (P=32, F=4, T=2048, N=262,144): xyzt 4.2 MB +
// tables 1.0 MB + out 134.2 MB = 139.5 MB, 0.042 ms at 3.35 TB/s. The old
// (idx, w) interface read 536 MB more. The arithmetic, ~90 integer and fp32
// operations of corner math per sample and pair, 32 table reads and 32
// multiply-adds, is close behind: the kernel sits between bytes and issue.
// Backward: g 134.2 MB + xyzt 4.2 MB + dtab 1.0 MB, the same 0.042 ms. Its
// cost is the C*F adds per sample into a small table. An fp32 atomicAdd on
// shared memory is a compare-and-swap loop on this card (ATOMS.CAST.SPIN),
// so adds that collide retry, and at real samples many collide: consecutive
// samples lie on one ray and share their coarse levels' corners.
//
// ---- Forward design ----------------------------------------------------------
// A block owns one pair, a chunk of at most 8 features and a long range of
// samples that it walks in tiles of 1,024 (4 consecutive samples a thread);
// the launch is one wave of blocks, so each stages its slab once. When the
// chunk's (fc, T) slab fits kSlabBytes (the grids' whole (4, 2048) slab is
// 32 KB, the vectors' 8 of 32 features 64 KB), the block stages it in shared
// memory transposed to (T, fc): a corner's features are then one 16-byte
// shared load. The staging transposes, so it is a plain load loop rather
// than cp.async; it moves 32 KB per block against ~1 MB of output written by
// the block. Larger tables (the reference-capacity T = 2^19, 4 MB per pair)
// are gathered with __ldg from L2. Stores are float4 along n when N % 4 == 0.
//
// ---- Backward design ---------------------------------------------------------
// As fused_interp.cu's backward, the sums are privatised per block in an fp32
// shared slab (pair, sample range, <= 8 features; feature-major), zeroed on
// entry and flushed with one global atomicAdd per non-zero entry; tables
// larger than a slab add straight into dtab with global atomics. New here,
// against the collisions at real samples: each thread owns kBwdRun
// consecutive samples (a run along one ray) and keeps each corner's sum in
// registers while that corner's index stays the same, adding to the slab
// only when it changes. At the coarse levels a ray's samples share their
// corners, so most adds vanish; at random positions the index changes every
// sample and the kernel adds as often as before. Registers are capped so
// that 4 blocks fit an SM (more warps to cover the loops' retries), and the
// launch is cut into 4 waves, which evens out blocks whose adds collide more
// than others'. Atomics add in a run-dependent order; the sums are fp32.
//
// ---- Skipped slots --------------------------------------------------------
// Both directions take two optional inputs, read from device memory so that
// a launch needs no host read and replays unchanged in a CUDA graph: a slot
// count n_valid (slots at or past *n_valid are skipped: the empty tail of a
// static sample budget) and a per-sample segment id seg with the segment s
// the call serves (samples of other segments are skipped: a multi-segment
// model's routing, the JAX package's where-masking). A skipped sample writes
// 0 in the forward and adds nothing in the backward. The grid stays sized by
// N, so the launch is static. With n_valid, the blocks split the live
// prefix [0, *n_valid) evenly among them, read from device memory at run
// time (see live_range), and the forward's blocks also split the tail's
// zeros; a block with no live sample neither stages nor flushes a slab. Each
// kernel is built with and without this skip code (kSkip); a call with
// neither input runs the build without it, the kernel as it was before.
//
// Both entry points launch on the caller's stream, allocate nothing, do not
// synchronise and return cudaGetLastError(). They take any N, any T < 2^31,
// and P <= 65,535.

#include <cuda_runtime.h>
#include <stdint.h>

// Tuning knobs, measured on the H100 with builds of `-D` variants (see
// PERF.md): the backward's run length (samples per thread), the
// blocks per SM that ptxas must fit in registers (__launch_bounds__' second
// argument; 4 lets the backward hide its shared-memory atomics, which are
// compare-and-swap loops, ATOMS.CAST.SPIN, for fp32) and the waves of
// blocks each direction's launch is cut into.
#ifndef FIELD_INTERP_BWD_RUN
#define FIELD_INTERP_BWD_RUN 8
#endif
#ifndef FIELD_INTERP_MIN_BLOCKS
#define FIELD_INTERP_MIN_BLOCKS 4
#endif
#ifndef FIELD_INTERP_FWD_WAVES
#define FIELD_INTERP_FWD_WAVES 1
#endif
#ifndef FIELD_INTERP_BWD_WAVES
#define FIELD_INTERP_BWD_WAVES 4
#endif

constexpr int kMaxLevels = 32;

// Passed by value (ctypes.Structure in humanrf_torch/ops/field_interp.py).
struct FieldSpec {
  int32_t mode;      // kModeGrid or kModeVector
  int32_t n_levels;  // grid: L (P = 4L); vector: unused
  float scale[kMaxLevels];
  int32_t resolution[kMaxLevels];
  int32_t dense[kMaxLevels];
};

// The field query's limit on segments per launch: its parameters take 88 B
// a segment, 22.8 KB in all at 256, under the 32 KB that a kernel's
// parameters may hold on Hopper (see "The field query" below). 256 holds any
// partitioning of 1000 frames (167 segments at the ladder's smallest, 6).
constexpr int kMaxSegments = 256;

// One segment's tables and, for the backward, their gradients (zeroed).
struct SegmentTables {
  const float* grid[4];  // (L, F, T) each: xyz, xyt, yzt, xzt
  const float* vectors;  // (4, L*F, R)
  float* dgrid[4];       // backward: (L, F, T) each
  float* dvectors;       // backward: (4, L*F, R)
  uint32_t T;
  uint32_t dense;  // bit l: level l indexes densely (res^3 <= T)
};

// The field query's, passed by value (ctypes.Structure in
// humanrf_torch/ops/field_interp.py).
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

constexpr int kModeGrid = 0;
constexpr int kModeVector = 1;
constexpr int kThreads = 256;
constexpr int kFwdPerThread = 4;  // consecutive samples per thread and tile (float4 stores)
constexpr int kBwdRun = FIELD_INTERP_BWD_RUN;
constexpr int kMinBlocks = FIELD_INTERP_MIN_BLOCKS;
constexpr int kFwdWaves = FIELD_INTERP_FWD_WAVES;
constexpr int kBwdWaves = FIELD_INTERP_BWD_WAVES;
constexpr int kSlabBytes = 64 * 1024;
constexpr uint32_t kOutside = 0xFFFFFFFFu;  // a corner outside [0, T)

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// This block's range [begin, end) of the samples it computes. Without
// n_valid, block x takes [x*spb, (x+1)*spb). With it, the live prefix
// [0, *n_valid), which is what costs, is split evenly over the blocks of the
// (unchanged) grid, in parts that are multiples of `align` and at least
// `min_part` (a staged slab's floor): were the blocks laid over all N, only
// those over the prefix would work, a third of the card or less at the
// dense step's budgets.
__device__ __forceinline__ void live_range(const int32_t* n_valid, int64_t N, int64_t spb, int64_t align,
                                           int64_t min_part, int64_t& begin, int64_t& end) {
  if (n_valid == nullptr) {
    begin = static_cast<int64_t>(blockIdx.x) * spb;
    end = min(N, begin + spb);
    return;
  }
  const int64_t live = min(N, static_cast<int64_t>(max(__ldg(n_valid), 0)));
  int64_t part = max((live + gridDim.x - 1) / gridDim.x, min_part);
  part = (part + align - 1) / align * align;
  begin = min(live, static_cast<int64_t>(blockIdx.x) * part);
  end = min(live, begin + part);
}

// Whether sample n (below the live end) belongs to the segment served.
__device__ __forceinline__ bool served(const int32_t* seg, int seg_id, int64_t n) {
  return seg == nullptr || __ldg(seg + n) == seg_id;
}

// The corner math of one sample for one pair, in registers.
struct PairSetup {
  int coord;      // grid: the dropped axis of (x, y, z, t); vector: the axis read
  float scale;    // grid: level scale; vector: R
  uint32_t res;   // grid: level resolution
  bool dense;
  uint32_t T;
  bool pow2;
};

__device__ __forceinline__ PairSetup pair_setup(const FieldSpec& spec, int p, uint32_t T) {
  PairSetup s;
  s.T = T;
  s.pow2 = (T & (T - 1)) == 0;
  if (spec.mode == kModeGrid) {
    const int L = spec.n_levels;
    const int g = p / L, l = p % L;
    // Grids xyz, xyt, yzt, xzt drop t, z, x, y.
    s.coord = g == 0 ? 3 : g == 1 ? 2 : g == 2 ? 0 : 1;
    s.scale = spec.scale[l];
    s.res = static_cast<uint32_t>(spec.resolution[l]);
    s.dense = spec.dense[l] != 0;
  } else {
    s.coord = p;
    s.scale = static_cast<float>(T);
    s.res = T;
    s.dense = true;
  }
  return s;
}

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

// kFC features of one table entry from the (T, kFC) shared slab.
template <int kFC>
__device__ __forceinline__ void load_slab(const float* slab, uint32_t t, float (&v)[kFC]) {
  const float* e = slab + static_cast<size_t>(t) * kFC;
  if constexpr (kFC == 1) {
    v[0] = e[0];
  } else if constexpr (kFC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(e);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < kFC / 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(e)[k];
      v[4 * k] = a.x;
      v[4 * k + 1] = a.y;
      v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
  }
}

// Grid (sample ranges, feature chunks, P). kStaged: dynamic shared memory of
// T*kFC floats, the chunk's slab transposed to (T, kFC). kSkip: the call has
// skip inputs (n_valid or seg); without them the skip code compiles away and
// the kernel is the one it was before they existed.
template <int kC, int kFC, bool kStaged, bool kSkip>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
field_fwd_kernel(const float* __restrict__ tables,  // (P, F, T)
                 const float4* __restrict__ xyzt,   // (N, 4)
                 float* __restrict__ out,           // (P, F, N)
                 const FieldSpec spec, int F, uint32_t T, int64_t N, int64_t samples_per_block,
                 bool vec_store, const int32_t* __restrict__ n_valid, const int32_t* __restrict__ seg, int seg_id,
                 int64_t min_part) {
  extern __shared__ float4 smem[];
  float* slab = reinterpret_cast<float*>(smem);
  const int p = blockIdx.z;
  const int f0 = blockIdx.y * kFC;
  const int fc = min(kFC, F - f0);
  int64_t n_begin, n_end;  // the same for the whole block
  live_range(kSkip ? n_valid : nullptr, N, samples_per_block, kThreads * kFwdPerThread, min_part, n_begin, n_end);
  const float* tab = tables + (static_cast<int64_t>(p) * F + f0) * T;

  if (kSkip && n_valid != nullptr) {
    // The empty tail [*n_valid, N), split evenly over the blocks: zeros.
    const int64_t live = min(N, static_cast<int64_t>(max(__ldg(n_valid), 0)));
    const int64_t part = (N - live + gridDim.x - 1) / gridDim.x;
    const int64_t t_begin = live + static_cast<int64_t>(blockIdx.x) * part;
    const int64_t t_end = min(N, t_begin + part);
    for (int f = 0; f < fc; ++f) {
      float* row = out + (static_cast<int64_t>(p) * F + f0 + f) * N;
      for (int64_t n = t_begin + threadIdx.x; n < t_end; n += kThreads) row[n] = 0.0f;
    }
  }

  if (kStaged && (!kSkip || n_begin < n_end)) {
#pragma unroll
    for (int f = 0; f < kFC; ++f) {
      for (uint32_t t = threadIdx.x; t < T; t += kThreads) {
        slab[static_cast<size_t>(t) * kFC + f] = f < fc ? __ldg(tab + static_cast<int64_t>(f) * T + t) : 0.0f;
      }
    }
    __syncthreads();
  }
  const PairSetup s = pair_setup(spec, p, T);

  for (int64_t n0 = n_begin + static_cast<int64_t>(threadIdx.x) * kFwdPerThread; n0 < n_end;
       n0 += kThreads * kFwdPerThread) {
    float acc[kFwdPerThread][kFC];
#pragma unroll
    for (int j = 0; j < kFwdPerThread; ++j) {
#pragma unroll
      for (int f = 0; f < kFC; ++f) acc[j][f] = 0.0f;
      if (n0 + j < n_end && (!kSkip || served(seg, seg_id, n0 + j))) {
        uint32_t idx[kC];
        float w[kC];
        corners<kC>(s, __ldg(xyzt + n0 + j), idx, w);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (idx[c] == kOutside) continue;
          float v[kFC];
          if constexpr (kStaged) {
            load_slab<kFC>(slab, idx[c], v);
          } else {
#pragma unroll
            for (int f = 0; f < kFC; ++f) v[f] = f < fc ? __ldg(tab + static_cast<int64_t>(f) * T + idx[c]) : 0.0f;
          }
#pragma unroll
          for (int f = 0; f < kFC; ++f) acc[j][f] = __fadd_rn(acc[j][f], __fmul_rn(w[c], v[f]));
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kFC; ++f) {
      if (f >= fc) break;
      float* row = out + (static_cast<int64_t>(p) * F + f0 + f) * N;
      if (vec_store && n0 + kFwdPerThread <= n_end) {
        *reinterpret_cast<float4*>(row + n0) = make_float4(acc[0][f], acc[1][f], acc[2][f], acc[3][f]);
      } else {
#pragma unroll
        for (int j = 0; j < kFwdPerThread; ++j) {
          if (n0 + j < n_end) row[n0 + j] = acc[j][f];
        }
      }
    }
  }
}

// Grid (sample ranges, feature chunks, P). kStaged: dynamic shared memory of
// T*kFC floats, the chunk's gradient slab as (kFC, T); otherwise global
// atomics. (Feature-major, unlike the forward's slab: a warp's adds for one
// feature then spread over all 32 banks, where (T, kFC) would put them on
// 32 / kFC of them.) kSkip as the forward's.
template <int kC, int kFC, bool kStaged, bool kSkip>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
field_bwd_kernel(const float* __restrict__ g,       // (P, F, N)
                 const float4* __restrict__ xyzt,   // (N, 4)
                 float* __restrict__ dtab,          // (P, F, T), zeroed
                 const FieldSpec spec, int F, uint32_t T, int64_t N, int64_t samples_per_block,
                 const int32_t* __restrict__ n_valid, const int32_t* __restrict__ seg, int seg_id,
                 int64_t min_part) {
  extern __shared__ float4 smem[];
  float* slab = reinterpret_cast<float*>(smem);
  const int p = blockIdx.z;
  const int f0 = blockIdx.y * kFC;
  const int fc = min(kFC, F - f0);
  int64_t n_begin, n_end;
  live_range(kSkip ? n_valid : nullptr, N, samples_per_block, kThreads * kBwdRun, min_part, n_begin, n_end);
  if (kSkip && n_begin >= n_end) return;  // no live sample (uniform over the block)
  float* dst = dtab + (static_cast<int64_t>(p) * F + f0) * T;
  const float* grow = g + (static_cast<int64_t>(p) * F + f0) * N;

  if constexpr (kStaged) {
    for (uint32_t i = threadIdx.x; i < T * kFC; i += kThreads) slab[i] = 0.0f;
    __syncthreads();
  }
  const PairSetup s = pair_setup(spec, p, T);

  // Adds one corner's run sum, then starts the next run.
  auto flush = [&](uint32_t t, const float (&sum)[kFC]) {
    if (t == kOutside) return;
#pragma unroll
    for (int f = 0; f < kFC; ++f) {
      if (f >= fc) break;
      if constexpr (kStaged) {
        atomicAdd(slab + static_cast<size_t>(f) * T + t, sum[f]);
      } else {
        atomicAdd(dst + static_cast<int64_t>(f) * T + t, sum[f]);
      }
    }
  };

  for (int64_t n0 = n_begin + static_cast<int64_t>(threadIdx.x) * kBwdRun; n0 < n_end;
       n0 += kThreads * kBwdRun) {
    uint32_t cur[kC];
    float run[kC][kFC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      cur[c] = kOutside;
#pragma unroll
      for (int f = 0; f < kFC; ++f) run[c][f] = 0.0f;
    }
    const int len = static_cast<int>(min(static_cast<int64_t>(kBwdRun), n_end - n0));
    for (int j = 0; j < len; ++j) {
      const int64_t n = n0 + j;
      if (kSkip && !served(seg, seg_id, n)) continue;
      float gv[kFC];
#pragma unroll
      for (int f = 0; f < kFC; ++f) gv[f] = f < fc ? __ldg(grow + static_cast<int64_t>(f) * N + n) : 0.0f;
      uint32_t idx[kC];
      float w[kC];
      corners<kC>(s, __ldg(xyzt + n), idx, w);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (idx[c] != cur[c]) {
          flush(cur[c], run[c]);
          cur[c] = idx[c];
#pragma unroll
          for (int f = 0; f < kFC; ++f) run[c][f] = 0.0f;
        }
#pragma unroll
        for (int f = 0; f < kFC; ++f) run[c][f] = fmaf(w[c], gv[f], run[c][f]);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) flush(cur[c], run[c]);
  }

  if constexpr (kStaged) {
    __syncthreads();
    for (int f = 0; f < fc; ++f) {
      for (uint32_t t = threadIdx.x; t < T; t += kThreads) {
        const float v = slab[static_cast<size_t>(f) * T + t];
        if (v != 0.0f) atomicAdd(dst + static_cast<int64_t>(f) * T + t, v);
      }
    }
  }
}

// The launch plan: feature chunk, staging, then the grid (size_grid).
struct Plan {
  int fc;  // kFC: 1, 2, 4 or 8
  bool staged;
  int chunks;
  int smem;
  int64_t spb = 0;  // samples per block
  int64_t min_spb = 0;  // the floor of a block's samples (staged slabs)
  unsigned ranges = 0;
};

int cover(int F) { return F <= 1 ? 1 : F <= 2 ? 2 : F <= 4 ? 4 : 8; }

Plan make_plan(int F, uint32_t T) {
  Plan pl;
  pl.fc = cover(F);
  while (pl.fc > 1 && static_cast<int64_t>(pl.fc) * T * 4 > kSlabBytes) pl.fc /= 2;
  pl.staged = static_cast<int64_t>(pl.fc) * T * 4 <= kSlabBytes;
  if (!pl.staged) pl.fc = cover(F);
  pl.chunks = (F + pl.fc - 1) / pl.fc;
  pl.smem = pl.staged ? static_cast<int>(pl.fc * T * 4) : 0;
  return pl;
}

// `waves` full waves of `kernel` (a wave is as many blocks as the card holds
// at once), each block taking an equal range of samples, a multiple of
// `tile`, and for a staged slab at least 4*T/C samples, so that staging or
// flushing it (fc*T entries) stays small against the block's work. The
// forward takes one wave (each block stages its slab once); the backward
// several, which evens out blocks whose adds collide more than others'.
template <typename Kernel>
cudaError_t size_grid(Kernel kernel, Plan& pl, int P, int64_t N, int C, uint32_t T, int tile, int waves) {
  cudaError_t err = cudaSuccess;
  if (pl.smem > 48 * 1024) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, pl.smem);
  if (err != cudaSuccess) return err;
  const int64_t pairs_chunks = static_cast<int64_t>(P) * pl.chunks;
  int64_t per_pc = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) * waves / pairs_chunks;
  if (per_pc < 1) per_pc = 1;
  int64_t spb = (N + per_pc - 1) / per_pc;
  const int64_t floor_spb = pl.staged ? (4 * static_cast<int64_t>(T) + C - 1) / C : 0;
  if (spb < floor_spb) spb = floor_spb;
  pl.min_spb = floor_spb;
  pl.spb = (spb + tile - 1) / tile * tile;
  pl.ranges = static_cast<unsigned>((N + pl.spb - 1) / pl.spb);
  return cudaSuccess;
}

dim3 grid_of(const Plan& pl, int P) {
  return dim3(pl.ranges, static_cast<unsigned>(pl.chunks), static_cast<unsigned>(P));
}

bool valid_args(const FieldSpec& spec, int P, int F, long long T, long long N) {
  if (F < 1 || T < 1 || T >= (1LL << 31) || P > 65535 || N < 0) return false;
  if (spec.mode == kModeGrid) return spec.n_levels >= 1 && spec.n_levels <= kMaxLevels && P == 4 * spec.n_levels;
  return spec.mode == kModeVector && P == 4;
}

template <int kC, int kFC, bool kStaged, bool kSkip>
struct FwdLaunch {
  static cudaError_t run(const float* tables, const float* xyzt, float* out, const FieldSpec& spec, int P, int F,
                         uint32_t T, int64_t N, const int32_t* n_valid, const int32_t* seg, int seg_id,
                         cudaStream_t s, Plan pl) {
    auto kernel = field_fwd_kernel<kC, kFC, kStaged, kSkip>;
    const cudaError_t err = size_grid(kernel, pl, P, N, kC, T, kThreads * kFwdPerThread, kFwdWaves);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(pl, P), kThreads, pl.smem, s>>>(tables, reinterpret_cast<const float4*>(xyzt), out, spec, F, T,
                                                     N, pl.spb, N % 4 == 0, n_valid, seg, seg_id, pl.min_spb);
    return cudaGetLastError();
  }
};

template <int kC, int kFC, bool kStaged, bool kSkip>
struct BwdLaunch {
  static cudaError_t run(const float* g, const float* xyzt, float* dtab, const FieldSpec& spec, int P, int F,
                         uint32_t T, int64_t N, const int32_t* n_valid, const int32_t* seg, int seg_id,
                         cudaStream_t s, Plan pl) {
    auto kernel = field_bwd_kernel<kC, kFC, kStaged, kSkip>;
    const cudaError_t err = size_grid(kernel, pl, P, N, kC, T, kThreads * kBwdRun, kBwdWaves);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(pl, P), kThreads, pl.smem, s>>>(g, reinterpret_cast<const float4*>(xyzt), dtab, spec, F, T, N,
                                                     pl.spb, n_valid, seg, seg_id, pl.min_spb);
    return cudaGetLastError();
  }
};

// Dispatch on (corners, feature chunk, staging, skip inputs) to one instantiation.
template <int kC, template <int, int, bool, bool> class Launch, typename... Args>
cudaError_t dispatch(const Plan& pl, bool skip, Args... args) {
#define FIELD_INTERP_CASE(FC)                                                                                 \
  case FC:                                                                                                    \
    if (skip) {                                                                                               \
      return pl.staged ? Launch<kC, FC, true, true>::run(args..., pl) : Launch<kC, FC, false, true>::run(args..., pl); \
    }                                                                                                         \
    return pl.staged ? Launch<kC, FC, true, false>::run(args..., pl) : Launch<kC, FC, false, false>::run(args..., pl);
  switch (pl.fc) {
    FIELD_INTERP_CASE(1)
    FIELD_INTERP_CASE(2)
    FIELD_INTERP_CASE(4)
    FIELD_INTERP_CASE(8)
  }
#undef FIELD_INTERP_CASE
  return cudaErrorInvalidValue;
}

template <template <int, int, bool, bool> class Launch>
int run_entry(const float* a, const float* xyzt, float* o, const FieldSpec& spec, int P, int F, long long T,
              long long N, const int32_t* n_valid, const int32_t* seg, int seg_id, void* stream) {
  if (P <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (!valid_args(spec, P, F, T, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(F, static_cast<uint32_t>(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t t32 = static_cast<uint32_t>(T);
  const int64_t n64 = static_cast<int64_t>(N);
  const bool skip = n_valid != nullptr || seg != nullptr;
  const cudaError_t err =
      spec.mode == kModeGrid ? dispatch<8, Launch>(pl, skip, a, xyzt, o, spec, P, F, t32, n64, n_valid, seg, seg_id, s)
                             : dispatch<2, Launch>(pl, skip, a, xyzt, o, spec, P, F, t32, n64, n_valid, seg, seg_id, s);
  return static_cast<int>(err);
}

// ---- The field query ------------------------------------------------------
//
//     out[n, l*F + f] = sum_g  f_g[l, f](n) * v_{p(g)}[l*F + f](n),  p = (3, 2, 0, 1)
//
// where f_g is grid g's lookup at level l and v_p vector p's, read from the
// tables of the sample's own segment. It does in one launch what the
// per-pair kernels leave to PyTorch: per segment a grid call and a vector
// call, each writing (4, L*F, N) fp32 lookups over the whole budget, then
// the sum over segments and the composition's products and sums; in the
// backward the cotangents grad * v_p and grad * f_g, another (4, L*F, N)
// tensor each, with their zero-filled selects and sums. The JAX package
// never has those tensors either: XLA fuses the composition into the
// lookups' consumers.
//
// Forward: a thread per (sample, level), levels fastest, so that the L
// threads of a sample write its L*F features as one coalesced row. It
// computes the four grids' corners and lookups at its level and the partner
// vectors' taps in registers, then the products and their sum in the order
// ((f0*v + f1*v) + f2*v) + f3*v, each step rounded on its own
// (__fmul_rn/__fadd_rn), and each lookup summed corner by corner as the
// per-pair forward sums it: the features equal the per-pair kernels followed
// by PyTorch's segment sum and composition bit for bit. It reads the tables
// where they lie, through L1 and L2 (__ldg): a thread needs the four grids
// of its level, which at the r4 width (4 x 32 KB per segment) do not fit
// beside other blocks in shared memory, and at the paper's T = 2^17 no
// table does. What bounds it: the gathers, 4 x 8 corners of F features and
// 4 x 2 taps per (sample, level), against an output of 4*L*F bytes a slot
// (128 B at L*F = 32), written once.
//
// Backward: a thread per (run of kBwdRun consecutive samples, level). For
// each grid g in turn it recomputes the sample's lookup f_g and the partner
// vector's v_p (nothing is kept from the forward), forms grad * v_p and
// grad * f_g in registers and adds w_c * grad * v_p into grid g's gradient
// and w_tap * grad * f_g into vector p's with global atomics. As in the
// per-pair backward, a corner's or tap's sum stays in registers while its
// index (and the segment) stays the same along the run, so the consecutive
// samples of a ray, which share their coarse corners and the time vector's
// taps, add once. Atomics add in a run-dependent order.
//
// Segments: `seg` (N,) int32 routes each sample to its segment; every
// segment's table pointers, table size and dense levels come in FieldQuery,
// passed by value (__grid_constant__: read in place, never copied per
// thread; up to 22.8 KB of parameters, which CUDA 12.1 and later take). A
// sample of no segment (seg outside [0, n_segments)), or at or past
// *n_valid, writes zeros and adds nothing. One launch serves every segment,
// and its grid is sized by N, so a CUDA graph replays it unchanged.

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
// and sum rounded on its own, as field_fwd_kernel sums them.
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

// out (P, F, N) f32; xyzt (N, 4) f32; tables (P, F, T) f32. n_valid (one
// int32) and seg ((N,) int32, with the segment seg_id served) may be null.
extern "C" int field_interp_fwd(const float* tables, const float* xyzt, float* out, FieldSpec spec, int P, int F,
                                long long T, long long N, const int32_t* n_valid, const int32_t* seg, int seg_id,
                                void* stream) {
  return run_entry<FwdLaunch>(tables, xyzt, out, spec, P, F, T, N, n_valid, seg, seg_id, stream);
}

// dtab (P, F, T) f32 must hold zeros on entry (the caller allocates it with torch.zeros).
extern "C" int field_interp_bwd(const float* g, const float* xyzt, float* dtab, FieldSpec spec, int P, int F,
                                long long T, long long N, const int32_t* n_valid, const int32_t* seg, int seg_id,
                                void* stream) {
  return run_entry<BwdLaunch>(g, xyzt, dtab, spec, P, F, T, N, n_valid, seg, seg_id, stream);
}

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
// q.seg[s].dgrid and .dvectors, shaped as the tables, must hold zeros on
// entry (the caller allocates them with torch.zeros). The rest as the
// forward's.
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
