// fused_interp for Hopper (sm_90a), forward and backward:
//
//     out[p, f, n]  = sum_c  w[p, c, n] * tables[p, f, idx[p, c, n]]         (forward)
//     dtab[p, f, t] = sum_{n, c} g[p, f, n] * w[p, c, n] * [idx[p, c, n] == t] (backward)
//
// Replaces the TPU kernels of humanrf_tpu/ops/fused_interp.py: the forward
// _fwd_kernel (reached through _fused_interp_fwd_impl) and the backward
// _bwd_kernel (reached through _fused_interp_bwd). The TPU has no fast gather
// or scatter, so both Pallas kernels build bf16 one-hot rows (T, TN) in VMEM
// and contract them with the table (forward) or the cotangent (backward) on
// the MXU. A GPU gathers and scatters directly, so these kernels compute the
// contract itself and keep everything fp32.
//
// A corner whose index lies outside [0, T) contributes nothing, in either
// direction, as in the TPU kernels, whose one-hot rows have no entry for it (a
// dense hash-grid level's far corner can index past a table of
// res^3 <= T < res^3 + res^2 + res). Offsets are 64-bit, so any table size T
// works. The kernels launch on the caller's stream, allocate nothing and do
// not synchronise; each C entry point returns cudaGetLastError().
//
// ---- Forward ---------------------------------------------------------------
// What bounds it on an H100: random 4-byte reads of the tables (C*F per
// sample; at the model's shapes the tables are ~2 MB per segment and stay
// resident in the 50 MB L2), plus streaming idx/w at 8 B per corner-sample and
// the output at 4 B per feature-sample. There is no arithmetic to speak of.
//
// Design: one thread owns one (p, n). It loads its C indices and weights once
// into registers (coalesced across the warp: n is the contiguous axis), then
// for each feature row f reads tables[p, f, idx[c]] through the read-only
// cache, sums in fp32 over c = 0..C-1 in order, and stores out[p, f, n]
// (coalesced). No shared memory: a vector table (F*T*4 B = 256 KB per pair)
// does not fit, and the L2 already holds the grids. An out-of-table corner is
// read at index 0 with weight 0, so no read leaves the table.
//
// ---- Backward --------------------------------------------------------------
// What bounds it: streaming g (F*4 B per sample) plus idx and w (8 B per
// corner-sample) is ~0.65 GB per call at the grid shape (P=32, C=8, F=4,
// N=262,144), ~0.2 ms of HBM at 3.35 TB/s. The real cost is the C*F atomic
// adds per sample into a small table: at the grid shape 8.4M adds per pair
// land on 8,192 addresses, ~1,000 adds on each.
//
// Design: the sums are privatised in shared memory. A block owns (pair p, a
// chunk of samples, a chunk of at most kMaxFChunk features). It zeroes an
// (f_chunk, T) fp32 slab in dynamic shared memory, accumulates g*w into it
// with shared-memory atomicAdd (each thread loads its sample's g values once
// into registers), and flushes the slab with one global atomicAdd per
// non-zero entry. The slab budget is kSlabBytes: the grids' whole (4, 2048)
// slab is 32 KB, the vectors take 8 of their 32 features (64 KB, above the
// 48 KB default, hence cudaFuncSetAttribute). A chunk of samples is long
// enough that its adds outnumber the flush's by ~8x. Where even one feature
// row does not fit (the reference-capacity T = 2^19), a second kernel adds
// straight into the table with global atomicAdd: such tables are L2-resident
// up to 50 MB. Atomics add in a run-dependent order; the sums are fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCorners = 8;
constexpr int kThreads = 256;
constexpr int kMaxFChunk = 8;
constexpr int kSlabBytes = 64 * 1024;
constexpr int64_t kMinSamplesPerBlock = 4096;

__global__ void __launch_bounds__(kThreads)
fused_interp_fwd_kernel(const float* __restrict__ tables,  // (P, F, T)
                        const int32_t* __restrict__ idx,   // (P, C, N)
                        const float* __restrict__ w,       // (P, C, N)
                        float* __restrict__ out,           // (P, F, N)
                        int C, int F, int64_t T, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (n >= N) return;

  int32_t ci[kMaxCorners];
  float cw[kMaxCorners];
#pragma unroll
  for (int c = 0; c < kMaxCorners; ++c) {
    if (c < C) {
      const int64_t off = (p * C + c) * N + n;
      const int32_t i = __ldg(idx + off);
      const bool in_table = i >= 0 && i < T;
      ci[c] = in_table ? i : 0;
      cw[c] = in_table ? __ldg(w + off) : 0.0f;
    }
  }

  for (int f = 0; f < F; ++f) {
    const float* row = tables + (p * F + f) * T;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCorners; ++c) {
      if (c < C) acc = fmaf(cw[c], __ldg(row + ci[c]), acc);
    }
    out[(p * F + f) * N + n] = acc;
  }
}

// Grid (sample chunks, feature chunks, P); dynamic shared memory f_chunk*T floats.
__global__ void __launch_bounds__(kThreads)
fused_interp_bwd_slab_kernel(const float* __restrict__ g,      // (P, F, N)
                             const int32_t* __restrict__ idx,  // (P, C, N)
                             const float* __restrict__ w,      // (P, C, N)
                             float* __restrict__ dtab,         // (P, F, T), zeroed
                             int C, int F, int f_chunk, int64_t T, int64_t N,
                             int64_t samples_per_block) {
  extern __shared__ float slab[];  // (fc, T)
  const int64_t p = blockIdx.z;
  const int f0 = blockIdx.y * f_chunk;
  const int fc = min(f_chunk, F - f0);
  const int64_t n_begin = static_cast<int64_t>(blockIdx.x) * samples_per_block;
  const int64_t n_end = min(N, n_begin + samples_per_block);
  const int64_t slab_size = fc * T;

  for (int64_t i = threadIdx.x; i < slab_size; i += kThreads) slab[i] = 0.0f;
  __syncthreads();

  for (int64_t n = n_begin + threadIdx.x; n < n_end; n += kThreads) {
    float gv[kMaxFChunk];
#pragma unroll
    for (int f = 0; f < kMaxFChunk; ++f) {
      if (f < fc) gv[f] = __ldg(g + (p * F + f0 + f) * N + n);
    }
    for (int c = 0; c < C; ++c) {
      const int64_t off = (p * C + c) * N + n;
      const int32_t i = __ldg(idx + off);
      if (i < 0 || i >= T) continue;
      const float wv = __ldg(w + off);
#pragma unroll
      for (int f = 0; f < kMaxFChunk; ++f) {
        if (f < fc) atomicAdd(slab + f * T + i, wv * gv[f]);
      }
    }
  }
  __syncthreads();

  float* out = dtab + (p * F + f0) * T;
  for (int64_t i = threadIdx.x; i < slab_size; i += kThreads) {
    const float v = slab[i];
    if (v != 0.0f) atomicAdd(out + i, v);
  }
}

// Grid (sample blocks, P): one thread per (p, n), global atomics.
__global__ void __launch_bounds__(kThreads)
fused_interp_bwd_global_kernel(const float* __restrict__ g,      // (P, F, N)
                               const int32_t* __restrict__ idx,  // (P, C, N)
                               const float* __restrict__ w,      // (P, C, N)
                               float* __restrict__ dtab,         // (P, F, T), zeroed
                               int C, int F, int64_t T, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (n >= N) return;

  int32_t ci[kMaxCorners];
  float cw[kMaxCorners];
#pragma unroll
  for (int c = 0; c < kMaxCorners; ++c) {
    if (c < C) {
      const int64_t off = (p * C + c) * N + n;
      const int32_t i = __ldg(idx + off);
      ci[c] = (i >= 0 && i < T) ? i : -1;  // -1: out of the table, adds nothing
      cw[c] = __ldg(w + off);
    }
  }

  for (int f = 0; f < F; ++f) {
    const float gv = __ldg(g + (p * F + f) * N + n);
    float* row = dtab + (p * F + f) * T;
#pragma unroll
    for (int c = 0; c < kMaxCorners; ++c) {
      if (c < C && ci[c] >= 0) atomicAdd(row + ci[c], cw[c] * gv);
    }
  }
}

bool valid_args(int P, int C, int F, long long T) {
  return C >= 1 && C <= kMaxCorners && F >= 1 && T >= 1 && P <= 65535;
}

}  // namespace

extern "C" int fused_interp_fwd(const float* tables, const int32_t* idx, const float* w,
                                float* out, int P, int C, int F, long long T, long long N,
                                void* stream) {
  if (P <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (!valid_args(P, C, F, T)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads), static_cast<unsigned>(P));
  fused_interp_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, idx, w, out, C, F, static_cast<int64_t>(T), static_cast<int64_t>(N));
  return static_cast<int>(cudaGetLastError());
}

// dtab must hold zeros on entry (the caller allocates it with torch.zeros).
extern "C" int fused_interp_bwd(const float* g, const int32_t* idx, const float* w,
                                float* dtab, int P, int C, int F, long long T, long long N,
                                void* stream) {
  if (P <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (!valid_args(P, C, F, T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long rows_that_fit = kSlabBytes / (T * static_cast<long long>(sizeof(float)));
  if (rows_that_fit == 0) {
    const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads), static_cast<unsigned>(P));
    fused_interp_bwd_global_kernel<<<grid, kThreads, 0, s>>>(
        g, idx, w, dtab, C, F, static_cast<int64_t>(T), static_cast<int64_t>(N));
    return static_cast<int>(cudaGetLastError());
  }

  long long fc = rows_that_fit;
  if (fc > F) fc = F;
  if (fc > kMaxFChunk) fc = kMaxFChunk;
  const int f_chunk = static_cast<int>(fc);
  const int smem_bytes = static_cast<int>(f_chunk * T * sizeof(float));
  // Per device and cheap; set on every launch so no state is kept here.
  const cudaError_t err = cudaFuncSetAttribute(
      fused_interp_bwd_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Enough samples per block that its adds (samples*C*fc) outnumber its
  // flush (fc*T) by ~8x, and at least kMinSamplesPerBlock.
  long long spb = (8 * T + C - 1) / C;
  if (spb < kMinSamplesPerBlock) spb = kMinSamplesPerBlock;
  spb = (spb + kThreads - 1) / kThreads * kThreads;
  const dim3 grid(static_cast<unsigned>((N + spb - 1) / spb), static_cast<unsigned>((F + f_chunk - 1) / f_chunk),
                  static_cast<unsigned>(P));
  fused_interp_bwd_slab_kernel<<<grid, kThreads, smem_bytes, s>>>(
      g, idx, w, dtab, C, F, f_chunk, static_cast<int64_t>(T), static_cast<int64_t>(N),
      static_cast<int64_t>(spb));
  return static_cast<int>(cudaGetLastError());
}
