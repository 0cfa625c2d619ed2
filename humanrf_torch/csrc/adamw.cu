// adamw for Hopper (sm_90a): the optimizer step of humanrf_torch's AdamW
// (train/trainer.py) over every parameter tensor in two launches, or a few
// when the tensors outnumber one launch's table:
//
//   adamw_finite:  *bad |= any element of any gradient is inf or NaN
//   adamw_update:  if *finite, for every element of every tensor
//                    m' = (1-b1)*g + b1*m,   v' = (1-b2)*g*g + b2*v
//                    u  = (m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p
//                    p' = p + step_size*u
//
// Replaces no TPU kernel. The JAX package's optimizer is optax's adamw inside
// apply_if_finite, which XLA fuses into the jitted step; the port's eager
// body (AdamW._update_plain) makes about a dozen elementwise PyTorch ops a
// parameter tensor (mul, add, pow, div, sqrt, three where, three copy_) and
// an isfinite().all() that writes a bool a parameter: ~200 B of device
// memory traffic a parameter. These kernels move 32 B.
//
// ---- What bounds them on an H100 ---------------------------------------------
// Bytes. The update reads p, g, m and v and writes p, m and v: 28 B a
// parameter, ~15 fp32 operations, far below the card's ridge. The 1000-frame
// model's 676,341,312 parameters move 18.9 GB, 5.65 ms at 3.35 TB/s; the
// finiteness reduction reads the gradients again (4 B, 0.81 ms). So the
// design only has to keep enough bytes in flight and move no byte twice.
//
// ---- Design --------------------------------------------------------------------
// The tensors come as a pointer table (AdamWTable: p, g, m, v, n and the
// tensor's first chunk), passed by value as a __grid_constant__ parameter,
// at most kMaxTensors a launch (12.3 KB, under the 32 KB a kernel's
// parameters may hold on Hopper); the host splits a longer list of tensors
// into more launches (ops/adamw.py::plan). Each tensor is cut into chunks of
// kChunk elements, numbered across the table; a launch is one wave of blocks
// (as many as fit the card at once), each walking the chunks grid-stride and
// finding a chunk's tensor by advancing a cursor over the table. A chunk is
// read as 16-byte float4 loads, two a thread and stream, when all of its
// tensor's pointers are 16-byte aligned (a scalar tail for the last 1-3
// elements), and element by element otherwise (a view at an odd offset).
// Offsets are 64-bit. A null gradient pointer is a zero gradient, never read.
//
// The finiteness reduction keeps no bool tensor: each thread ANDs its
// elements' finiteness in a register, the block reduces with
// __syncthreads_and, and a block that saw a non-finite value sets *bad with
// one atomicOr. The update reads the (possibly group-agreed) flag first: when
// it is false every block returns without touching memory, which is
// apply_if_finite's skip, decided on the device.
//
// ---- Arithmetic ------------------------------------------------------------------
// Exactly the eager body's, in its order, in fp32, so the two agree bit for
// bit: every product, sum, quotient and root is written with the _rn
// intrinsics, so nvcc contracts nothing into an FMA that PyTorch's separate
// ops do not make. The Python constants (1-b1, b1, 1-b2, b2, eps, wd) come
// as fp32, as PyTorch rounds a Python float scalar for a float32 tensor; the
// step size and the bias corrections bc1 = 1 - b1^t, bc2 = 1 - b2^t are the
// eager body's own 0-dim device tensors, read through pointers, so a CUDA
// graph replays the launch unchanged.
//
// Both entry points launch on the caller's stream, allocate nothing, do not
// synchronise and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// The tensors one launch takes (kMaxTensors in humanrf_torch/ops/adamw.py).
constexpr int kMaxTensors = 256;

// One parameter tensor: the parameter, its gradient (null: zero), both
// moments, all n elements long, and the first of its chunks in the launch.
struct AdamWTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
  long long chunk0;
};

// Passed by value (ctypes.Structure in humanrf_torch/ops/adamw.py).
struct AdamWTable {
  int32_t n_tensors;
  long long n_chunks;
  AdamWTensor t[kMaxTensors];
};

// The update's constants: fp32 scalars and the eager body's 0-dim tensors.
struct AdamWConstants {
  float one_minus_b1, b1, one_minus_b2, b2, eps, wd;
  const float* step_size;
  const float* bc1;
  const float* bc2;
};

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 2;                                  // float4s a thread reads per chunk and stream
constexpr long long kChunk = kThreads * kQuads * 4;        // 2048 elements (CHUNK in ops/adamw.py)
constexpr int kScalarSteps = static_cast<int>(kChunk / kThreads);

// The table entry of chunk c, from the cursor `i` on: a block's chunks grow
// along its walk, so the cursor only advances.
__device__ __forceinline__ int tensor_of(const AdamWTable& tab, long long c, int i) {
  while (i + 1 < tab.n_tensors && c >= tab.t[i + 1].chunk0) ++i;
  return i;
}

__device__ __forceinline__ bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15u) == 0; }

__device__ __forceinline__ bool finite4(float4 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z) && isfinite(a.w);
}

__global__ void __launch_bounds__(kThreads) adamw_finite_kernel(const __grid_constant__ AdamWTable tab, int* bad) {
  bool ok = true;
  int i = 0;
  for (long long c = blockIdx.x; c < tab.n_chunks; c += gridDim.x) {
    i = tensor_of(tab, c, i);
    const AdamWTensor& t = tab.t[i];
    if (t.g == nullptr) continue;  // a zero gradient
    const long long off = (c - t.chunk0) * kChunk;
    const long long len = min(kChunk, t.n - off);
    const float* g = t.g + off;
    if (aligned16(t.g)) {
      const long long quads = len / 4;
      float4 a[kQuads];
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const long long q = threadIdx.x + j * kThreads;
        a[j] = q < quads ? __ldg(reinterpret_cast<const float4*>(g) + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kQuads; ++j) ok = ok && finite4(a[j]);
      const long long e = quads * 4 + threadIdx.x;
      if (e < len) ok = ok && isfinite(__ldg(g + e));
    } else {
#pragma unroll 4
      for (int j = 0; j < kScalarSteps; ++j) {
        const long long e = threadIdx.x + static_cast<long long>(j) * kThreads;
        if (e < len) ok = ok && isfinite(__ldg(g + e));
      }
    }
  }
  if (!__syncthreads_and(ok) && threadIdx.x == 0) atomicOr(bad, 1);
}

struct Scalars {
  float step, bc1, bc2;
};

// One element, in the eager body's order of operations.
__device__ __forceinline__ void update(const AdamWConstants& k, const Scalars& s, float& p, float g, float& m,
                                       float& v) {
  const float m1 = __fadd_rn(__fmul_rn(k.one_minus_b1, g), __fmul_rn(k.b1, m));
  const float v1 = __fadd_rn(__fmul_rn(k.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, s.bc2)), k.eps);
  const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(m1, s.bc1), den), __fmul_rn(k.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.step, u));
  m = m1;
  v = v1;
}

__device__ __forceinline__ void update4(const AdamWConstants& k, const Scalars& s, float4& p, float4 g, float4& m,
                                        float4& v) {
  update(k, s, p.x, g.x, m.x, v.x);
  update(k, s, p.y, g.y, m.y, v.y);
  update(k, s, p.z, g.z, m.z, v.z);
  update(k, s, p.w, g.w, m.w, v.w);
}

__device__ __forceinline__ void update_at(const AdamWConstants& k, const Scalars& s, float* p, const float* g,
                                          float* m, float* v, long long e) {
  float pe = p[e], me = m[e], ve = v[e];
  update(k, s, pe, g == nullptr ? 0.0f : __ldg(g + e), me, ve);
  p[e] = pe;
  m[e] = me;
  v[e] = ve;
}

__global__ void __launch_bounds__(kThreads) adamw_update_kernel(const __grid_constant__ AdamWTable tab,
                                                                const __grid_constant__ AdamWConstants k,
                                                                const uint8_t* finite) {
  if (__ldg(finite) == 0) return;  // apply_if_finite's skip: nothing is touched
  const Scalars s{__ldg(k.step_size), __ldg(k.bc1), __ldg(k.bc2)};
  int i = 0;
  for (long long c = blockIdx.x; c < tab.n_chunks; c += gridDim.x) {
    i = tensor_of(tab, c, i);
    const AdamWTensor& t = tab.t[i];
    const long long off = (c - t.chunk0) * kChunk;
    const long long len = min(kChunk, t.n - off);
    float* p = t.p + off;
    const float* g = t.g == nullptr ? nullptr : t.g + off;
    float* m = t.m + off;
    float* v = t.v + off;
    if (aligned16(t.p) && aligned16(t.g) && aligned16(t.m) && aligned16(t.v)) {
      const long long quads = len / 4;
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      float4 pa[kQuads], ga[kQuads], ma[kQuads], va[kQuads];
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const long long q = threadIdx.x + j * kThreads;
        if (q < quads) {
          pa[j] = p4[q];
          ga[j] = g == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f) : __ldg(reinterpret_cast<const float4*>(g) + q);
          ma[j] = m4[q];
          va[j] = v4[q];
        }
      }
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const long long q = threadIdx.x + j * kThreads;
        if (q < quads) {
          update4(k, s, pa[j], ga[j], ma[j], va[j]);
          p4[q] = pa[j];
          m4[q] = ma[j];
          v4[q] = va[j];
        }
      }
      const long long e = quads * 4 + threadIdx.x;
      if (e < len) update_at(k, s, p, g, m, v, e);
    } else {
#pragma unroll 4
      for (int j = 0; j < kScalarSteps; ++j) {
        const long long e = threadIdx.x + static_cast<long long>(j) * kThreads;
        if (e < len) update_at(k, s, p, g, m, v, e);
      }
    }
  }
}

bool valid_table(const AdamWTable& tab) {
  if (tab.n_tensors < 1 || tab.n_tensors > kMaxTensors || tab.n_chunks < 0) return false;
  long long chunks = 0;
  for (int i = 0; i < tab.n_tensors; ++i) {
    const AdamWTensor& t = tab.t[i];
    if (t.p == nullptr || t.m == nullptr || t.v == nullptr || t.n < 1 || t.chunk0 != chunks) return false;
    chunks += (t.n + kChunk - 1) / kChunk;
  }
  return chunks == tab.n_chunks;
}

// One wave: as many blocks as the card holds at once, at most one a chunk.
// Asked once per kernel (the first call is a step's eager one, before any
// graph capture).
template <typename Kernel>
unsigned wave(Kernel kernel, long long n_chunks) {
  static long long blocks = 0;
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    blocks = static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return static_cast<unsigned>(n_chunks < blocks ? n_chunks : blocks);
}

}  // namespace

// *bad (one int32) must hold 0 before the first launch of a step; every
// launch of the step ORs 1 into it where a gradient holds inf or NaN.
extern "C" int adamw_finite(AdamWTable tab, int* bad, void* stream) {
  if (!valid_table(tab) || bad == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  adamw_finite_kernel<<<wave(adamw_finite_kernel, tab.n_chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, bad);
  return static_cast<int>(cudaGetLastError());
}

// finite: one bool (uint8) on the device; false leaves every tensor as it is.
extern "C" int adamw_update(AdamWTable tab, AdamWConstants k, const uint8_t* finite, void* stream) {
  if (!valid_table(tab) || finite == nullptr || k.step_size == nullptr || k.bc1 == nullptr || k.bc2 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  adamw_update_kernel<<<wave(adamw_update_kernel, tab.n_chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, k, finite);
  return static_cast<int>(cudaGetLastError());
}
