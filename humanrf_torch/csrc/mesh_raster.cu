// mesh_raster for Hopper (sm_90a): triangle meshes into per-camera masks and
// depth maps, every camera of a frame in one pass.
//
// Replaces render_camera in humanrf_tpu/native/mesh_renderer/main.cpp
// (:227-285), the JAX package's host C++ rasterizer (a TPU cannot rasterize;
// the reference renders with OpenGL on the GPU). It has no Pallas ancestor.
// Two kernels, called by humanrf_torch/ops/rasterize.py:
//
// - mesh_project: one thread per (camera, vertex). w = v*scale, rel = w - t,
//   cam = R^T rel (each row (m0*x + m1*y) + m2*z), and where cam.z > 1e-6
//   px = (fx*W*x)/z + cx*W, py likewise; writes (px, py, z, 1/z) as a float4.
// - mesh_raster: one warp per (camera, triangle). Every lane does the
//   triangle's setup in the tool's order (near clip of the whole triangle,
//   the box from floorf/ceilf of the tool's min/max converted to int as
//   x86-64 converts, clamped to the image, the signed area and its 1e-12
//   skip, 1/area); then the lanes stride the box's pixels, so a triangle of
//   a few pixels and one that fills the screen both keep the warp busy. Per
//   pixel: w0, w1 at the centre, w2 = (1 - w0) - w1, reject any w < 0, iz =
//   (w0*iz0 + w1*iz1) + w2*iz2, z = 1/iz, and atomicMin on the bits of z in
//   the flat int32 buffer, which the caller fills with the bits of +inf. A
//   positive float's bits order as the float, so the buffer ends at the
//   least z per pixel: what the tool's strict-less z-buffer keeps in face
//   order, whatever order the atomics land in. z = +inf never marks a pixel.
//
// Every rounding step is written as __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn:
// nvcc contracts a*b + c into an fma by default, which moves edge pixels and
// depths by an ulp. With them the kernels equal the plain PyTorch version
// (rasterize_plain) and the native tool bit for bit.
//
// ---- What bounds them on an H100 ---------------------------------------------
// mesh_project moves 12 B per vertex in and 16 B per (camera, vertex) out:
// bytes. mesh_raster reads 12 B per face and 3 x 16 B of projections per
// (camera, triangle), and issues one 4-byte atomic per fragment: at 748^2
// and ~10^5 triangles per view that is ~5 MB per view, ~1.5 us at
// 3.35 TB/s. In this first design the warp's setup (~60 dependent fp32 and
// integer operations, repeated by all 32 lanes) and the integer division of
// each box pixel's index by the box width dominate a small triangle's cost;
// the atomics of neighbouring pixels land in one L2 line.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNear = 1e-6f;
constexpr float kMinArea = 1e-12f;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // grid-stride beyond ~32 blocks per SM

// static_cast<int>(f) as cvttss2si computes it: INT_MIN when f is out of
// int32 range or NaN (f is integral here, from floorf or ceilf).
__device__ __forceinline__ int to_int_x86(float f) {
  return (f >= -2147483648.0f && f < 2147483648.0f) ? static_cast<int>(f) : INT32_MIN;
}

// std::min({a, b, c}) and std::max({a, b, c}): the first extreme under <.
__device__ __forceinline__ float min3(float a, float b, float c) {
  float m = (b < a) ? b : a;
  return (c < m) ? c : m;
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  float m = (a < b) ? b : a;
  return (m < c) ? c : m;
}

// cams: (C, 16) float32 = R^T row-major (9), t (3), fx*W, fy*H, cx*W, cy*H.
__global__ void mesh_project_kernel(const float* __restrict__ verts, long long V, const float* __restrict__ cams,
                                    int C, float scale, float4* __restrict__ proj) {
  const long long total = static_cast<long long>(C) * V;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i / V);
    const long long v = i - static_cast<long long>(c) * V;
    const float* cam = cams + 16 * c;
    const float rx = __fsub_rn(__fmul_rn(verts[3 * v + 0], scale), cam[9]);
    const float ry = __fsub_rn(__fmul_rn(verts[3 * v + 1], scale), cam[10]);
    const float rz = __fsub_rn(__fmul_rn(verts[3 * v + 2], scale), cam[11]);
    float row[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      row[r] = __fadd_rn(__fadd_rn(__fmul_rn(cam[3 * r], rx), __fmul_rn(cam[3 * r + 1], ry)),
                         __fmul_rn(cam[3 * r + 2], rz));
    float px = 0.0f, py = 0.0f;
    if (row[2] > kNear) {
      px = __fadd_rn(__fdiv_rn(__fmul_rn(cam[12], row[0]), row[2]), cam[14]);
      py = __fadd_rn(__fdiv_rn(__fmul_rn(cam[13], row[1]), row[2]), cam[15]);
    }
    proj[i] = make_float4(px, py, row[2], __fdiv_rn(1.0f, row[2]));
  }
}

// cam_ints: (C, 3) int64 = W, H, offset of the camera's image in zbuf.
__global__ void mesh_raster_kernel(const float4* __restrict__ proj, long long V, const int* __restrict__ faces,
                                   long long F, const long long* __restrict__ cam_ints, int C, int* __restrict__ zbuf) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long total = static_cast<long long>(C) * F;
  for (long long job = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5; job < total;
       job += warps) {
    const int c = static_cast<int>(job / F);
    const long long f = job - static_cast<long long>(c) * F;
    const float4* p = proj + static_cast<long long>(c) * V;
    const float4 a = p[faces[3 * f]], b = p[faces[3 * f + 1]], d = p[faces[3 * f + 2]];
    if (a.z <= kNear || b.z <= kNear || d.z <= kNear) continue;  // near-clip the whole triangle
    const int W = static_cast<int>(cam_ints[3 * c]), H = static_cast<int>(cam_ints[3 * c + 1]);
    const long long offset = cam_ints[3 * c + 2];
    const int minx = max(0, to_int_x86(floorf(min3(a.x, b.x, d.x))));
    const int maxx = min(W - 1, to_int_x86(ceilf(max3(a.x, b.x, d.x))));
    const int miny = max(0, to_int_x86(floorf(min3(a.y, b.y, d.y))));
    const int maxy = min(H - 1, to_int_x86(ceilf(max3(a.y, b.y, d.y))));
    if (minx > maxx || miny > maxy) continue;
    const float area = __fsub_rn(__fmul_rn(__fsub_rn(b.x, a.x), __fsub_rn(d.y, a.y)),
                                 __fmul_rn(__fsub_rn(d.x, a.x), __fsub_rn(b.y, a.y)));
    if (fabsf(area) < kMinArea) continue;
    const float inv_area = __fdiv_rn(1.0f, area);
    const int box_w = maxx - minx + 1;
    const int pixels = box_w * (maxy - miny + 1);  // at most W*H
    for (int k = lane; k < pixels; k += 32) {
      const int x = minx + k % box_w, y = miny + k / box_w;
      const float pxc = __fadd_rn(static_cast<float>(x), 0.5f), pyc = __fadd_rn(static_cast<float>(y), 0.5f);
      const float w0 = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(b.x, pxc), __fsub_rn(d.y, pyc)),
                                           __fmul_rn(__fsub_rn(d.x, pxc), __fsub_rn(b.y, pyc))), inv_area);
      const float w1 = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(d.x, pxc), __fsub_rn(a.y, pyc)),
                                           __fmul_rn(__fsub_rn(a.x, pxc), __fsub_rn(d.y, pyc))), inv_area);
      const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
      if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) continue;
      const float iz = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.w), __fmul_rn(w1, b.w)), __fmul_rn(w2, d.w));
      const float z = __fdiv_rn(1.0f, iz);
      if (!(z < INFINITY)) continue;
      atomicMin(zbuf + offset + static_cast<long long>(y) * W + x, __float_as_int(z));
    }
  }
}

int grid_for(long long threads) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// proj (C, V, 4) float32 out. Returns the launch's cudaError_t.
extern "C" int mesh_project(const float* verts, long long V, const float* cams, int C, float scale, float* proj,
                            void* stream) {
  if (V <= 0 || C <= 0) return cudaErrorInvalidValue;
  mesh_project_kernel<<<grid_for(static_cast<long long>(C) * V), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, V, cams, C, scale, reinterpret_cast<float4*>(proj));
  return static_cast<int>(cudaGetLastError());
}

// zbuf (sum of W*H) int32 must hold the bits of +inf on entry. Face indices
// must lie in [0, V) (the caller checks).
extern "C" int mesh_raster(const float* proj, long long V, const int* faces, long long F, const long long* cam_ints,
                           int C, int* zbuf, void* stream) {
  if (V <= 0 || F <= 0 || C <= 0) return cudaErrorInvalidValue;
  mesh_raster_kernel<<<grid_for(static_cast<long long>(C) * F * 32), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(reinterpret_cast<const float4*>(proj), V, faces, F,
                                                            cam_ints, C, zbuf);
  return static_cast<int>(cudaGetLastError());
}
