// mesh_raster for Hopper (sm_90a): triangle meshes into per-camera masks and
// depth maps, every camera of a frame in one pass.
//
// Replaces render_camera in humanrf_tpu/native/mesh_renderer/main.cpp
// (:227-285), the JAX package's host C++ rasterizer (a TPU cannot rasterize;
// the reference renders with OpenGL on the GPU). It has no Pallas ancestor.
// Called by humanrf_torch/ops/rasterize.py, per frame:
//
// - mesh_project: one thread per (camera, vertex), the camera from the
//   block's y index. w = v*scale, rel = w - t, cam = R^T rel (each row
//   (m0*x + m1*y) + m2*z), and where cam.z > 1e-6 px = (fx*W*x)/z + cx*W, py
//   likewise; writes (px, py, z, 1/z) as one 16-byte store. The passes
//   below read it back from L2 instead of projecting each corner again.
// - mesh_bin, launched twice: one thread per (camera, triangle) does the
//   setup in the tool's order (near clip of the whole triangle, the box from
//   floorf/ceilf of the tool's min/max converted to int as x86-64 converts,
//   clamped to the image, the signed area and its 1e-12 skip) and lists the
//   triangle in every TILE x TILE screen tile its box touches. The first
//   launch counts per tile (a warp's triangles that fall in one tile take
//   one atomic) and its last block sums the counts; the caller reads the
//   lists' length; the second launch writes each face into its tiles'
//   slices of one flat list.
// - mesh_raster: one block per (tile, chunk of CHUNK listed triangles) keeps
//   the tile's depth in shared memory (TILE^2 int32). A thread walks each
//   small box (at most SMALL_BOX pixels within the tile) itself; a warp takes
//   each larger one (the subject's thin sides), its rows' pixels dealt to
//   the lanes in turn, only the x range of each row that a conservative
//   band test leaves (see row_ranges). Per pixel: w0, w1 at the
//   centre, w2 = (1 - w0) - w1, reject any w < 0, iz = (w0*iz0 + w1*iz1) +
//   w2*iz2, z = 1/iz, and a shared-memory atomicMin on the bits of z where
//   it is below the tile's: a positive float's bits order as the float, so
//   the tile ends at the least z per pixel, which is what the tool's
//   strict-less z-buffer keeps in face order, whatever order the fragments
//   land in. z = +inf never marks a pixel. The block then writes each
//   pixel's mask (0/255) and depth (0 where uncovered) once, 4 pixels per
//   store. A crowded tile's chunks merge through the tile's buffer in device
//   memory, and the last of them writes the pixels.
//
// Every rounding step of the tool's arithmetic is written as
// __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn: nvcc contracts a*b + c into an
// fma by default, which moves edge pixels and depths by an ulp. With them
// the kernels equal the plain PyTorch version (rasterize_plain) and the
// native tool bit for bit. The row ranges only skip pixels that the exact
// test rejects; every pixel they keep is tested exactly.
//
// ---- What bounds them on an H100 ---------------------------------------------
// The step's least work is its output: 1 B of mask and 4 B of depth per
// pixel, 9.9 GB for the ActorsHQ rig's 160 views of 4112 x 3008 (3.0 ms at
// 3.35 TB/s), 33.6 MB for 12 views of 748^2. The earlier design filled a
// 4-byte depth buffer, sent every fragment to it as a global atomic, and
// read it back to write mask and depth: 13 B per pixel and a DRAM sector per
// fragment once the buffer is larger than L2. Here the depth stays in
// shared memory, so the raster pass writes each output byte once; the
// tiles add the lists (4 B per (triangle, tile)) and the setup, done three
// times per triangle from projections that L2 holds. The rest is the
// fragment test, ~25 fp32 operations per box pixel: a thin triangle's box
// can hold 100x its pixels (the r4 subject's rods), which the row ranges cut
// to the pixels near it, dealt over a warp's lanes; and at 748^2 a tile
// can list 22k triangles, which the chunks spread over blocks. The same
// walks into a depth buffer in device memory with global atomicMin (one
// pass, large boxes on a work list, then a pass that writes mask and depth)
// took 17.2 ms per 12 MP frame against these tiles' 11.4 + 1.4 (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(MESH_TILE_LOG2) || !defined(MESH_SMALL_BOX) || !defined(MESH_CHUNK)
#error "build with -DMESH_TILE_LOG2=... -DMESH_SMALL_BOX=... -DMESH_CHUNK=... (ops/rasterize.py passes them)"
#endif

namespace {

constexpr float kNear = 1e-6f;
constexpr float kMinArea = 1e-12f;
constexpr int kInfBits = 0x7F800000;  // the bits of +inf: no fragment
constexpr int kTileLog2 = MESH_TILE_LOG2;
constexpr int kTile = 1 << kTileLog2;
constexpr int kSmallBox = MESH_SMALL_BOX;  // box pixels that one thread walks
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBinThreads = 1024;  // mesh_bin's blocks: the last one sums the counts
constexpr int kChunk = MESH_CHUNK;  // listed triangles per raster block; a tile with more is crowded
constexpr int kQueue = kChunk;  // a block's triangles for its warps: room for the whole chunk
// The prefix sum carries (pairs, crowded tiles) packed in one int64: up to
// 2^40 pairs and 2^23 crowded tiles.
constexpr int kCrowdShift = 40;
constexpr long long kPairsMask = (1LL << kCrowdShift) - 1;
// Camera ints, (C, kCamInts) int64: W, H, the image's offset in the flat
// pixel buffers, tiles across, tiles down, the first tile's index.
constexpr int kCamInts = 6;

struct Camera {
  int W, H, tiles_x, tiles_y;
  long long offset, tile_base;
};

__device__ __forceinline__ Camera load_camera(const long long* cam_ints, int c) {
  const long long* p = cam_ints + kCamInts * c;
  return {static_cast<int>(p[0]), static_cast<int>(p[1]), static_cast<int>(p[3]), static_cast<int>(p[4]), p[2], p[5]};
}

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

struct Tri {
  float4 a, b, d;  // px, py, z, 1/z of the three corners
  float inv_area;
  int minx, maxx, miny, maxy;  // the box, clamped to the image
};

// The tool's per-triangle setup → false where it draws nothing.
__device__ __forceinline__ bool setup(const float4* __restrict__ p, const int* __restrict__ faces, int f, int W, int H,
                                      Tri& t) {
  t.a = p[faces[3 * f]];
  t.b = p[faces[3 * f + 1]];
  t.d = p[faces[3 * f + 2]];
  const float4 a = t.a, b = t.b, d = t.d;
  if (a.z <= kNear || b.z <= kNear || d.z <= kNear) return false;  // near-clip the whole triangle
  t.minx = max(0, to_int_x86(floorf(min3(a.x, b.x, d.x))));
  t.maxx = min(W - 1, to_int_x86(ceilf(max3(a.x, b.x, d.x))));
  t.miny = max(0, to_int_x86(floorf(min3(a.y, b.y, d.y))));
  t.maxy = min(H - 1, to_int_x86(ceilf(max3(a.y, b.y, d.y))));
  if (t.minx > t.maxx || t.miny > t.maxy) return false;
  const float area = __fsub_rn(__fmul_rn(__fsub_rn(b.x, a.x), __fsub_rn(d.y, a.y)),
                               __fmul_rn(__fsub_rn(d.x, a.x), __fsub_rn(b.y, a.y)));
  if (fabsf(area) < kMinArea) return false;
  t.inv_area = __fdiv_rn(1.0f, area);
  return true;
}

// The tool's per-pixel test at the pixel centre (pxc, pyc) = (x + 0.5, y +
// 0.5) → the bits of z, or kInfBits where the pixel is not drawn.
__device__ __forceinline__ int fragment(const Tri& t, float pxc, float pyc) {
  const float4 a = t.a, b = t.b, d = t.d;
  const float w0 = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(b.x, pxc), __fsub_rn(d.y, pyc)),
                                       __fmul_rn(__fsub_rn(d.x, pxc), __fsub_rn(b.y, pyc))), t.inv_area);
  const float w1 = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(d.x, pxc), __fsub_rn(a.y, pyc)),
                                       __fmul_rn(__fsub_rn(a.x, pxc), __fsub_rn(d.y, pyc))), t.inv_area);
  const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
  if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) return kInfBits;
  const float iz = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.w), __fmul_rn(w1, b.w)), __fmul_rn(w2, d.w));
  const float z = __fdiv_rn(1.0f, iz);
  return (z < INFINITY) ? __float_as_int(z) : kInfBits;
}

// The centre of pixel x: x + 0.5 in float32 (exact for |x| < 2^23).
__device__ __forceinline__ float centre(int x) { return __fadd_rn(static_cast<float>(x), 0.5f); }

// Row ranges of a large triangle. The exact test can accept a pixel only
// within a float32 rounding distance of the triangle; with S the corners'
// extent + 2 (so that every box pixel centre lies within S of each corner)
// and u = 2^-24, each edge value carries an error below 8 u S^2, i.e. a
// distance below 8 u S^2 / (the edge's length). The ranges are computed in
// float32 too, each crossing within a few ulps of the corners' magnitude R.
// The margin takes 32 times the first, 2^-16 R for the second, and a pixel.
// The triangle must be fat enough that the float area's sign is right
// (|area| >= 2^-12 S^2, far above its 8 u S^2 error) and its extent below
// 2^22; otherwise (and for a NaN or infinite corner) the whole box row is
// walked.
struct Ranges {
  float x[3], y[3], slope[3], m;  // slope: dx/dy of the edge from corner i to corner i + 1
  bool on;
};

__device__ __forceinline__ Ranges row_ranges(const Tri& t) {
  Ranges r;
  r.x[0] = t.a.x, r.x[1] = t.b.x, r.x[2] = t.d.x;
  r.y[0] = t.a.y, r.y[1] = t.b.y, r.y[2] = t.d.y;
  const float S = fmaxf(max3(r.x[0], r.x[1], r.x[2]) - min3(r.x[0], r.x[1], r.x[2]),
                        max3(r.y[0], r.y[1], r.y[2]) - min3(r.y[0], r.y[1], r.y[2])) + 2.0f;
  const float R = fmaxf(fmaxf(fmaxf(fabsf(r.x[0]), fabsf(r.x[1])), fmaxf(fabsf(r.x[2]), fabsf(r.y[0]))),
                        fmaxf(fabsf(r.y[1]), fabsf(r.y[2])));
  const float area = fabsf((r.x[1] - r.x[0]) * (r.y[2] - r.y[0]) - (r.x[2] - r.x[0]) * (r.y[1] - r.y[0]));
  float len2 = INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = i == 2 ? 0 : i + 1;
    const float dx = r.x[j] - r.x[i], dy = r.y[j] - r.y[i];
    len2 = fminf(len2, dx * dx + dy * dy);
    r.slope[i] = dy != 0.0f ? dx / dy : 0.0f;
  }
  // S < 2^22 is false for NaN and infinity.
  r.on = S < 4194304.0f && area >= S * S * 0x1p-12f;
  r.m = r.on ? 1.0f + S * S * 0x1p-16f * rsqrtf(len2) * 1.001f + R * 0x1p-16f : 0.0f;
  return r;
}

// The x extent of the triangle within the band lo <= y <= hi → false where
// the band misses it. The extent of a convex polygon: its corners within the
// band and its edges' crossings of the band's two lines.
__device__ __forceinline__ bool band_extent(const Ranges& r, float lo, float hi, float& xlo, float& xhi) {
  xlo = INFINITY;
  xhi = -INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (r.y[i] >= lo && r.y[i] <= hi) {
      xlo = fminf(xlo, r.x[i]);
      xhi = fmaxf(xhi, r.x[i]);
    }
    const int j = i == 2 ? 0 : i + 1;
    if (r.y[i] == r.y[j]) continue;  // a level edge: its ends are corners
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float yb = k ? hi : lo;
      if ((yb - r.y[i]) * (yb - r.y[j]) <= 0.0f) {
        const float xb = r.x[i] + (yb - r.y[i]) * r.slope[i];
        xlo = fminf(xlo, xb);
        xhi = fmaxf(xhi, xb);
      }
    }
  }
  return xlo <= xhi;
}

// The pixels [xs, xe] of rows lo..hi whose centres lie within the margin of
// the triangle's extent over those rows (dilated by the margin), within
// [x0, x1] → false where none is left.
__device__ __forceinline__ bool row_range(const Ranges& r, int lo, int hi, int x0, int x1, int& xs, int& xe) {
  float xlo, xhi;
  if (!band_extent(r, lo + 0.5f - r.m, hi + 0.5f + r.m, xlo, xhi)) return false;
  // Clamped before the conversion, so that it stays within int range.
  xs = max(x0, static_cast<int>(ceilf(fminf(fmaxf(xlo - r.m - 0.5f, x0 - 1.0f), x1 + 1.0f))));
  xe = min(x1, static_cast<int>(floorf(fminf(fmaxf(xhi + r.m - 0.5f, x0 - 1.0f), x1 + 1.0f))));
  return xs <= xe;
}

// One thread: every pixel of [x0, x1] x [y0, y1], as one loop over the box's
// pixels, so that a warp's lanes with boxes of one area and other shapes
// take as many steps.
template <class Sink>
__device__ __forceinline__ void walk_box(const Tri& t, int x0, int x1, int y0, int y1, Sink sink) {
  const int n = (x1 - x0 + 1) * (y1 - y0 + 1);
  const float cx0 = centre(x0), cx1 = centre(x1);
  float cx = cx0, cy = centre(y0);  // pixel centres step by exactly 1 (|x|, |y| < 2^23)
  for (int k = 0, x = x0, y = y0; k < n; ++k) {
    const int bits = fragment(t, cx, cy);
    if (bits != kInfBits) sink(x, y, bits);
    const bool wrap = cx == cx1;
    x = wrap ? x0 : x + 1;
    y += wrap;
    cx = wrap ? cx0 : __fadd_rn(cx, 1.0f);
    cy = wrap ? __fadd_rn(cy, 1.0f) : cy;
  }
}

// One warp: the pixels of [x0, x1] x [y0, y1] that the row ranges leave
// (every pixel where they are off), rows of 32 at a time. The rows' pixels
// are dealt to the lanes in turn (a lane finds its row by a binary search
// over the rows' running totals), so that every lane works whatever the
// rows' lengths: a thin triangle's rows are short, a flat one's few.
template <class Sink>
__device__ __forceinline__ void walk_rows(const Tri& t, int x0, int x1, int y0, int y1, int lane, Sink sink) {
  const Ranges r = row_ranges(t);
  int xs = x0, xe = x1;
  if (r.on && !row_range(r, y0, y1, x0, x1, xs, xe)) return;  // the triangle misses the whole rectangle
  for (int base = y0; base <= y1; base += 32) {
    const int y = base + lane;
    int len = 0;
    xs = x0;
    if (y <= y1) {
      if (!r.on)
        len = x1 - x0 + 1;
      else if (row_range(r, y, y, x0, x1, xs, xe))
        len = xe - xs + 1;
    }
    int end = len;  // running total of the rows' lengths, this row's included
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += up;
    }
    const int start = end - len, total = __shfl_sync(0xffffffffu, end, 31);
    for (int k0 = 0; k0 < total; k0 += 32) {
      const int k = k0 + lane;
      int row = 0;  // the last row that starts at or before k
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(0xffffffffu, start, row + step) <= k) row += step;
      const int x = __shfl_sync(0xffffffffu, xs, row) + k - __shfl_sync(0xffffffffu, start, row);
      if (k < total) {
        const int bits = fragment(t, centre(x), centre(base + row));
        if (bits != kInfBits) sink(x, base + row, bits);
      }
    }
  }
}

// cams: (C, 16) float32 = R^T row-major (9), t (3), fx*W, fy*H, cx*W, cy*H.
__global__ void __launch_bounds__(kThreads) mesh_project_kernel(const float* __restrict__ verts, int V,
                                                                const float* __restrict__ cams, float scale,
                                                                float4* __restrict__ proj) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const float* cam = cams + 16 * blockIdx.y;
  const float rx = __fsub_rn(__fmul_rn(verts[3 * v + 0], scale), cam[9]);
  const float ry = __fsub_rn(__fmul_rn(verts[3 * v + 1], scale), cam[10]);
  const float rz = __fsub_rn(__fmul_rn(verts[3 * v + 2], scale), cam[11]);
  float row[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    row[k] = __fadd_rn(__fadd_rn(__fmul_rn(cam[3 * k], rx), __fmul_rn(cam[3 * k + 1], ry)),
                       __fmul_rn(cam[3 * k + 2], rz));
  float px = 0.0f, py = 0.0f;
  if (row[2] > kNear) {
    px = __fadd_rn(__fdiv_rn(__fmul_rn(cam[12], row[0]), row[2]), cam[14]);
    py = __fadd_rn(__fdiv_rn(__fmul_rn(cam[13], row[1]), row[2]), cam[15]);
  }
  proj[static_cast<long long>(blockIdx.y) * V + v] = make_float4(px, py, row[2], __fdiv_rn(1.0f, row[2]));
}

// By one block of kBinThreads, over counts[0, n): offsets[0, n] their
// exclusive prefix sum, slots[0, n) that of the crowded tiles (more than
// kChunk triangles: each takes a depth buffer in device memory), and
// scratch[1] = the pairs | crowded tiles << kCrowdShift, scratch[2] = the
// largest count. Rounds of 8 counts per thread: loaded and stored through
// shared memory in coalesced rows, summed by each thread over 8 in a row.
__device__ void prefix_sum(const int* __restrict__ counts, int n, int* __restrict__ offsets,
                           int* __restrict__ slots, long long* __restrict__ scratch) {
  constexpr int kRound = 8 * kBinThreads;
  __shared__ int stage[kRound + kRound / 32];  // padded by one word per 32: no bank conflicts
  __shared__ long long warp_sums[kBinThreads / 32];
  __shared__ int most;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto at = [](int e) { return e + (e >> 5); };
  if (threadIdx.x == 0) most = 0;
  long long carry = 0;
  for (int base = 0; base < n; base += kRound) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = k * kBinThreads + threadIdx.x;
      stage[at(e)] = base + e < n ? __ldcg(counts + base + e) : 0;  // L2: the other blocks' atomics
    }
    __syncthreads();
    int c[8], top = 0;
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[k] = stage[at(8 * threadIdx.x + k)];
      sum += c[k] + (static_cast<long long>(c[k] > kChunk) << kCrowdShift);
      top = max(top, c[k]);
    }
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0 && top) atomicMax(&most, top);
    long long run = sum;  // inclusive scan over the block
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run += up;
    }
    if (lane == 31) warp_sums[warp] = run;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < kBinThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long up = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += up;
      }
      if (lane < kBinThreads / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    run += carry + (warp ? warp_sums[warp - 1] : 0) - sum;  // exclusive start of this thread's 8
    const long long start = run;
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // the caller refuses 2^31 pairs or more
      stage[at(8 * threadIdx.x + k)] = static_cast<int>(run & kPairsMask);
      run += c[k] + (static_cast<long long>(c[k] > kChunk) << kCrowdShift);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = k * kBinThreads + threadIdx.x;
      if (base + e < n) offsets[base + e] = stage[at(e)];
    }
    __syncthreads();
    run = start;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      stage[at(8 * threadIdx.x + k)] = static_cast<int>(run >> kCrowdShift);
      run += c[k] + (static_cast<long long>(c[k] > kChunk) << kCrowdShift);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = k * kBinThreads + threadIdx.x;
      if (base + e < n) slots[base + e] = stage[at(e)];
    }
    carry += warp_sums[kBinThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    offsets[n] = static_cast<int>(carry & kPairsMask);
    scratch[1] = carry;
    scratch[2] = most;
  }
}

// kFill false: counts[] (zero on entry) += the triangles listed per tile;
// the last block to finish writes offsets[] and slots[] (see prefix_sum;
// scratch[0] zero on entry counts the finished blocks). kFill true:
// counts[] and offsets[] as the first launch left them; writes each listed
// face into entries[offsets[tile] ..) and leaves counts[] at 0.
template <bool kFill>
__global__ void __launch_bounds__(kBinThreads, 2) mesh_bin_kernel(const float4* __restrict__ proj, int V,
                                                            const int* __restrict__ faces, int F,
                                                            const long long* __restrict__ cam_ints,
                                                            int* __restrict__ counts, int* __restrict__ offsets,
                                                            int* __restrict__ slots, int* __restrict__ entries,
                                                            int tiles, long long* __restrict__ scratch) {
  const int f = blockIdx.x * kBinThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const Camera cam = load_camera(cam_ints, blockIdx.y);
  Tri t;
  const bool drawn = f < F && setup(proj + static_cast<long long>(blockIdx.y) * V, faces, f, cam.W, cam.H, t);
  const int tx0 = drawn ? t.minx >> kTileLog2 : 0, tx1 = drawn ? t.maxx >> kTileLog2 : -1;
  const int ty0 = drawn ? t.miny >> kTileLog2 : 0, ty1 = drawn ? t.maxy >> kTileLog2 : -1;
  // The lanes whose triangle lies in one tile: one atomic per tile and warp.
  const bool one = drawn && tx0 == tx1 && ty0 == ty1;
  const long long key = one ? cam.tile_base + static_cast<long long>(ty0) * cam.tiles_x + tx0 : -1;
  const unsigned group = __match_any_sync(0xffffffffu, key);
  if (one) {
    const int leader = __ffs(group) - 1, rank = __popc(group & ((1u << lane) - 1u)), n = __popc(group);
    int base = 0;
    if (lane == leader) base = kFill ? atomicSub(counts + key, n) : atomicAdd(counts + key, n);
    base = __shfl_sync(group, base, leader);
    if (kFill) entries[offsets[key] + base - 1 - rank] = f;
  } else {
    for (int ty = ty0; ty <= ty1; ++ty)
      for (int tx = tx0; tx <= tx1; ++tx) {
        const long long tile = cam.tile_base + static_cast<long long>(ty) * cam.tiles_x + tx;
        if (kFill)
          entries[offsets[tile] + atomicSub(counts + tile, 1) - 1] = f;
        else
          atomicAdd(counts + tile, 1);
      }
  }
  if constexpr (!kFill) {
    // After the barrier, one fence orders the block's atomics (it is
    // cumulative) before its count of finished blocks.
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(reinterpret_cast<unsigned long long*>(scratch), 1ull) == 1ull * gridDim.x * gridDim.y - 1;
    }
    __syncthreads();
    if (last) prefix_sum(counts, tiles, offsets, slots, scratch);
  }
}

// Four pixels' mask and depth from the bits of their least z (kInfBits:
// not covered), with 4- and 16-byte stores where `vec`.
__device__ __forceinline__ void write4(int4 z, bool vec, int n, uint8_t* mask, float* depth) {
  const int bits[4] = {z.x, z.y, z.z, z.w};
  uint8_t m[4];
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = bits[k] != kInfBits ? 255 : 0;
    d[k] = bits[k] != kInfBits ? __int_as_float(bits[k]) : 0.0f;
  }
  if (vec) {
    *reinterpret_cast<uchar4*>(mask) = make_uchar4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(depth) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    for (int k = 0; k < n; ++k) {
      mask[k] = m[k];
      depth[k] = d[k];
    }
  }
}

// One block per (tile, camera, chunk of kChunk listed triangles): blockIdx.x
// is the tile within the camera, blockIdx.z the chunk. A tile of one chunk
// writes its pixels from shared memory. A crowded tile's chunks each fold
// their shared depth into the tile's buffer in device memory (atomicMax of
// kInfBits - bits into zeros), and the last of them writes the pixels.
__global__ void __launch_bounds__(kThreads, 6) mesh_raster_kernel(const float4* __restrict__ proj, int V,
                                                                  const int* __restrict__ faces,
                                                                  const long long* __restrict__ cam_ints,
                                                                  const int* __restrict__ offsets,
                                                                  const int* __restrict__ slots,
                                                                  const int* __restrict__ entries,
                                                                  int* __restrict__ crowd_z,
                                                                  int* __restrict__ crowd_done,
                                                                  uint8_t* __restrict__ mask,
                                                                  float* __restrict__ depth) {
  const Camera cam = load_camera(cam_ints, blockIdx.y);
  if (static_cast<int>(blockIdx.x) >= cam.tiles_x * cam.tiles_y) return;  // the camera has fewer tiles
  const long long tile = cam.tile_base + blockIdx.x;
  const int listed = offsets[tile + 1] - offsets[tile];
  const int chunks = listed > kChunk ? (listed + kChunk - 1) / kChunk : 1;
  if (static_cast<int>(blockIdx.z) >= chunks) return;
  const int start = offsets[tile] + blockIdx.z * kChunk, end = min(offsets[tile + 1], start + kChunk);
  const int x0 = (blockIdx.x % cam.tiles_x) << kTileLog2, y0 = (blockIdx.x / cam.tiles_x) << kTileLog2;
  const int x1 = min(x0 + kTile - 1, cam.W - 1), y1 = min(y0 + kTile - 1, cam.H - 1);
  const float4* p = proj + static_cast<long long>(blockIdx.y) * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 4-byte mask and 16-byte depth stores where every image row starts on 16 bytes.
  const bool vec = cam.W % 4 == 0 && cam.offset % 4 == 0;
  auto pixels = [&](int i, long long& at) {  // pixel i of the tile (a multiple of 4) → false outside the image
    const int x = x0 + (i & (kTile - 1)), y = y0 + (i >> kTileLog2);
    at = cam.offset + static_cast<long long>(y) * cam.W + x;
    return x <= x1 && y <= y1 ? min(4, x1 - x + 1) : 0;
  };
  if (listed == 0) {  // zeros, without the shared buffer
    for (int i = threadIdx.x * 4; i < kTile * kTile; i += kThreads * 4) {
      long long at;
      const int n = pixels(i, at);
      if (n) write4(make_int4(kInfBits, kInfBits, kInfBits, kInfBits), vec, n, mask + at, depth + at);
    }
    return;
  }

  __shared__ __align__(16) int zs[kTile * kTile];
  __shared__ int queue[kQueue];
  __shared__ int queued;
  __shared__ bool last;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) zs[i] = kInfBits;
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();
  auto sink = [&](int x, int y, int bits) {
    int* z = zs + ((y - y0) << kTileLog2) + (x - x0);
    if (bits < *z) atomicMin(z, bits);  // an occluded fragment takes no atomic
  };

  // Each thread walks the small boxes of its share of the chunk, with no
  // barrier in between, and queues the others for the warps.
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const int f = entries[i];
    Tri t;
    if (!setup(p, faces, f, cam.W, cam.H, t)) continue;  // listed, so drawn
    const int bx0 = max(t.minx, x0), bx1 = min(t.maxx, x1), by0 = max(t.miny, y0), by1 = min(t.maxy, y1);
    if ((bx1 - bx0 + 1) * (by1 - by0 + 1) <= kSmallBox) {
      walk_box(t, bx0, bx1, by0, by1, sink);
    } else {
      queue[atomicAdd(&queued, 1)] = f;
    }
  }
  __syncthreads();
  for (int k = warp; k < queued; k += kWarps) {
    Tri t;
    setup(p, faces, queue[k], cam.W, cam.H, t);
    walk_rows(t, max(t.minx, x0), min(t.maxx, x1), max(t.miny, y0), min(t.maxy, y1), lane, sink);
  }
  __syncthreads();

  if (chunks > 1) {
    const int slot = slots[tile];
    int* gz = crowd_z + static_cast<long long>(slot) * (kTile * kTile);
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads)
      if (zs[i] != kInfBits) atomicMax(gz + i, kInfBits - zs[i]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(crowd_done + slot, 1) == chunks - 1;
    __syncthreads();
    if (!last) return;
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int v = __ldcg(gz + i);
      zs[i] = v ? kInfBits - v : kInfBits;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x * 4; i < kTile * kTile; i += kThreads * 4) {
    long long at;
    const int n = pixels(i, at);
    if (n) write4(*reinterpret_cast<const int4*>(zs + i), vec, n, mask + at, depth + at);
  }
}

int blocks(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

// proj (C, V, 4) float32 out. Returns the launch's cudaError_t.
extern "C" int mesh_project(const float* verts, int V, const float* cams, int C, float scale, float* proj,
                            void* stream) {
  if (V <= 0 || C <= 0 || C > 65535) return cudaErrorInvalidValue;
  mesh_project_kernel<<<dim3(blocks(V), C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, V, cams, scale, reinterpret_cast<float4*>(proj));
  return static_cast<int>(cudaGetLastError());
}

// fill 0: counts (tiles), offsets (tiles + 1) and slots (tiles) int32 out,
// scratch three int64; waits for the stream and returns in out[0] the
// lists' length, out[1] the crowded tiles, out[2] the most triangles of a
// tile. fill 1: counts, offsets and slots as the first call left them,
// entries (out[0]) int32 out. Face indices must lie in [0, V) (the caller
// checks).
extern "C" int mesh_bin(const float* proj, int V, const int* faces, int F, const long long* cam_ints, int C,
                        int tiles, int* counts, int* offsets, int* slots, int* entries, long long* scratch, int fill,
                        long long* out, void* stream) {
  if (V <= 0 || F <= 0 || C <= 0 || C > 65535 || tiles <= 0) return cudaErrorInvalidValue;
  const dim3 grid((F + kBinThreads - 1) / kBinThreads, C);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = reinterpret_cast<const float4*>(proj);
  if (fill) {
    mesh_bin_kernel<true><<<grid, kBinThreads, 0, s>>>(p, V, faces, F, cam_ints, counts, offsets, slots, entries,
                                                       tiles, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(tiles), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(scratch, 0, 3 * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  mesh_bin_kernel<false><<<grid, kBinThreads, 0, s>>>(p, V, faces, F, cam_ints, counts, offsets, slots, entries,
                                                      tiles, scratch);
  err = cudaGetLastError();
  long long packed[2];
  if (err == cudaSuccess) err = cudaMemcpyAsync(packed, scratch + 1, sizeof(packed), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  out[0] = packed[0] & kPairsMask;
  out[1] = packed[0] >> kCrowdShift;
  out[2] = packed[1];
  return static_cast<int>(err);
}

// mask (all pixels) uint8 and depth float32 out; max_tiles: the most tiles
// of one camera; most: the most triangles listed in one tile; crowd_z
// (crowded * TILE^2) and crowd_done (crowded) int32 scratch.
extern "C" int mesh_raster(const float* proj, int V, const int* faces, const long long* cam_ints, int C,
                           int max_tiles, int most, const int* offsets, const int* slots, const int* entries,
                           int crowded, int* crowd_z, int* crowd_done, uint8_t* mask, float* depth, void* stream) {
  if (V < 0 || C <= 0 || C > 65535 || max_tiles <= 0 || most < 0 || crowded < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (crowded) {
    cudaError_t err = cudaMemsetAsync(crowd_z, 0, sizeof(int) * kTile * kTile * static_cast<size_t>(crowded), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(crowd_done, 0, sizeof(int) * static_cast<size_t>(crowded), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = most > kChunk ? (most + kChunk - 1) / kChunk : 1;
  mesh_raster_kernel<<<dim3(max_tiles, C, chunks), kThreads, 0, s>>>(reinterpret_cast<const float4*>(proj), V, faces,
                                                                     cam_ints, offsets, slots, entries, crowd_z,
                                                                     crowd_done, mask, depth);
  return static_cast<int>(cudaGetLastError());
}
