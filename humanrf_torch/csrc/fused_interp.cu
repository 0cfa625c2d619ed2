// fused_interp forward for Hopper (sm_90a):
//
//     out[p, f, n] = sum_c  w[p, c, n] * tables[p, f, idx[p, c, n]]
//
// Replaces the TPU kernel humanrf_tpu/ops/fused_interp.py::_fwd_kernel (reached
// through _fused_interp_fwd_impl). The TPU has no fast gather, so the Pallas
// kernel builds bf16 one-hot rows (T, TN) in VMEM and contracts them with the
// table on the MXU. A GPU gathers directly, so this kernel computes the
// contract itself and keeps everything fp32.
//
// What bounds it on an H100: random 4-byte reads of the tables (C*F per
// sample; at the model's shapes the tables are ~2 MB per segment and stay
// resident in the 50 MB L2), plus streaming idx/w at 8 B per corner-sample and
// the output at 4 B per feature-sample. There is no arithmetic to speak of.
//
// Design: one thread owns one (p, n). It loads its C indices and weights once
// into registers (coalesced across the warp: n is the contiguous axis), then
// for each feature row f reads tables[p, f, idx[c]] through the read-only
// cache, sums in fp32 over c = 0..C-1 in order, and stores out[p, f, n]
// (coalesced). Offsets are 64-bit, so any table size T works. No shared
// memory: a vector table (F*T*4 B = 256 KB per pair) does not fit, and the
// L2 already holds the grids. Launches on the caller's stream, allocates
// nothing and does not synchronise.
//
// A corner whose index lies outside [0, T) contributes nothing, as in the TPU
// kernel, whose one-hot rows have no entry for it (a dense hash-grid level's
// far corner can index past a table of res^3 <= T < res^3 + res^2 + res). It
// is read at index 0 with weight 0, so no read leaves the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCorners = 8;
constexpr int kThreads = 256;

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

}  // namespace

extern "C" int fused_interp_fwd(const float* tables, const int32_t* idx, const float* w,
                                float* out, int P, int C, int F, long long T, long long N,
                                void* stream) {
  if (P <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (C < 1 || C > kMaxCorners || F < 1 || T < 1 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads), static_cast<unsigned>(P));
  fused_interp_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, idx, w, out, C, F, static_cast<int64_t>(T), static_cast<int64_t>(N));
  return static_cast<int>(cudaGetLastError());
}
