"""Triangle rasterization into per-camera masks and depth maps.

Counterpart of `render_camera` in `humanrf_tpu/native/mesh_renderer/main.cpp`
(:227-285), the JAX package's host C++ rasterizer (a TPU cannot rasterize;
the reference renders its masks with OpenGL on the GPU). For CUDA tensors
`rasterize` launches the hand-written kernels of `humanrf_torch/csrc/
mesh_raster.cu`, `mesh_project` then `mesh_raster`; for CPU tensors it runs
`rasterize_plain`, the same arithmetic in eager PyTorch. There is no
fallback: a CUDA call that cannot build or launch raises.

Both follow the native tool's float32 operations in its order, so their
masks and depths equal the tool's bit for bit:

- projection: w = v·scale, rel = w − t, cam = Rᵀ·rel (each row (m0·x +
  m1·y) + m2·z), and where cam.z > 1e-6: px = (fx·W·x) / z + cx·W, py the
  same with fy·H, cy·H; 1/z per vertex;
- per triangle: skipped unless all three z > 1e-6; the box from floor/ceil
  of the tool's min/max, converted to int as x86-64 converts (a value out
  of int32 range, or NaN, becomes INT_MIN), clamped to the image; skipped
  when empty or when |area| < 1e-12; inv_area = 1 / area;
- per pixel of the box: w0, w1 at the pixel centre, w2 = (1 − w0) − w1,
  rejected if any w < 0, iz = (w0·iz0 + w1·iz1) + w2·iz2, z = 1 / iz;
- the depth test keeps the minimum z per pixel: the tool's strict-less
  z-buffer in face order keeps exactly the minimum, whatever order the
  fragments come in, and a z of +inf never marks a pixel.

Every camera's image lies in one flat float32 buffer at its own offset, so
cameras of different sizes share one pass.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from humanrf_torch.ops.cuda_build import load_library

# Kernel launches since the last reset, per kernel (each wrapper adds one
# where it launches its kernel).
launches = {"project": 0, "raster": 0}

NEAR = float(np.float32(1e-6))  # the tool's near clip, 1e-6f
MIN_AREA = float(np.float32(1e-12))
INT_MIN = -(2**31)
PLAIN_CHUNK = 1 << 22  # (triangle, box pixel) pairs per step of the plain version


def reset_launches() -> None:
    launches["project"] = launches["raster"] = 0


@dataclass
class CameraParams:
    """The cameras as the kernels read them. `floats` (C, 16) float32: the
    world-to-camera rotation Rᵀ row-major (9), the translation (3), fx·W,
    fy·H, cx·W, cy·H; `ints` (C, 3) int64: W, H and the image's offset in
    the flat buffer of `total` pixels."""

    floats: torch.Tensor
    ints: torch.Tensor
    sizes: List[Tuple[int, int]]  # (H, W) per camera
    total: int

    @classmethod
    def build(cls, cameras: Sequence, device) -> "CameraParams":
        """`cameras`: `toolbox.mesh_io.Camera`s (float32 calibration)."""
        floats = np.zeros((len(cameras), 16), dtype=np.float32)
        ints = np.zeros((len(cameras), 3), dtype=np.int64)
        offset = 0
        for i, cam in enumerate(cameras):
            width, height = np.float32(cam.width), np.float32(cam.height)
            floats[i, :9] = np.asarray(cam.rotation, dtype=np.float32).T.reshape(-1)
            floats[i, 9:12] = cam.translation
            floats[i, 12:] = [cam.fx * width, cam.fy * height, cam.cx * width, cam.cy * height]
            ints[i] = (cam.width, cam.height, offset)
            offset += cam.width * cam.height
        return cls(torch.tensor(floats, device=device), torch.tensor(ints, device=device),
                   [(cam.height, cam.width) for cam in cameras], offset)


def _check(vertices: torch.Tensor, faces: torch.Tensor):
    if vertices.dim() != 2 or vertices.shape[1] != 3 or faces.dim() != 2 or faces.shape[1] != 3:
        raise ValueError(f"expected vertices (V, 3) and faces (F, 3), got {tuple(vertices.shape)}, "
                         f"{tuple(faces.shape)}")
    if vertices.dtype != torch.float32 or faces.dtype != torch.int32:
        raise TypeError(f"expected float32 vertices and int32 faces, got {vertices.dtype}/{faces.dtype}")
    if vertices.device != faces.device:
        raise ValueError(f"tensors on different devices: {vertices.device}, {faces.device}")
    if vertices.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rasterize runs on cuda or cpu tensors, not {vertices.device}")
    if faces.numel() and (int(faces.min()) < 0 or int(faces.max()) >= vertices.shape[0]):
        raise ValueError(f"a face index lies outside the {vertices.shape[0]} vertices")


# ------------------------------------------------------------------ plain


def project_plain(vertices: torch.Tensor, params: CameraParams, scale: float) -> torch.Tensor:
    """(V, 3) → (C, V, 4): px, py, z, 1/z of every vertex in every camera
    (px = py = 0 where z ≤ 1e-6, as the kernel writes them)."""
    f = params.floats[:, :, None]
    w = vertices * float(np.float32(scale))
    rel = [w[:, k][None] - f[:, 9 + k] for k in range(3)]
    cam = [(f[:, 3 * r] * rel[0] + f[:, 3 * r + 1] * rel[1]) + f[:, 3 * r + 2] * rel[2] for r in range(3)]
    front = cam[2] > NEAR
    px = torch.where(front, (f[:, 12] * cam[0]) / cam[2] + f[:, 14], 0.0)
    py = torch.where(front, (f[:, 13] * cam[1]) / cam[2] + f[:, 15], 0.0)
    return torch.stack([px, py, cam[2], torch.reciprocal(cam[2])], dim=-1)


def _to_int_x86(value: torch.Tensor) -> torch.Tensor:
    """float → int32 as cvttss2si: out of range or NaN → INT_MIN."""
    ok = (value >= -2147483648.0) & (value < 2147483648.0)
    return torch.where(ok, value, float(INT_MIN)).to(torch.int64)


def _min3(a, b, c):
    """`std::min({a, b, c})`: the first smallest under `<`."""
    m = torch.where(b < a, b, a)
    return torch.where(c < m, c, m)


def _max3(a, b, c):
    """`std::max({a, b, c})`: the first largest under `<`."""
    m = torch.where(a < b, b, a)
    return torch.where(m < c, c, m)


def depth_buffer_plain(proj: torch.Tensor, faces: torch.Tensor, params: CameraParams,
                       chunk: int = PLAIN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain depth pass: (C, V, 4) projections → (flat float32 depth
    buffer, +inf where nothing was drawn; fragments drawn per camera)."""
    device = proj.device
    C = proj.shape[0]
    buf = torch.full((params.total,), float("inf"), dtype=torch.float32, device=device)
    fragments = torch.zeros(C, dtype=torch.int64, device=device)
    if C == 0 or faces.shape[0] == 0:
        return buf, fragments
    corners = proj[:, faces.long()]  # (C, F, 3, 4)
    x, y, z, iz = (corners[..., k] for k in range(4))
    width, height, offset = (params.ints[:, k, None] for k in range(3))
    valid = ~((z[..., 0] <= NEAR) | (z[..., 1] <= NEAR) | (z[..., 2] <= NEAR))  # a NaN z is not clipped
    minx = _to_int_x86(torch.floor(_min3(x[..., 0], x[..., 1], x[..., 2]))).clamp_min(0)
    maxx = torch.minimum(_to_int_x86(torch.ceil(_max3(x[..., 0], x[..., 1], x[..., 2]))), width - 1)
    miny = _to_int_x86(torch.floor(_min3(y[..., 0], y[..., 1], y[..., 2]))).clamp_min(0)
    maxy = torch.minimum(_to_int_x86(torch.ceil(_max3(y[..., 0], y[..., 1], y[..., 2]))), height - 1)
    valid &= (minx <= maxx) & (miny <= maxy)
    x0, x1, x2, y0, y1, y2 = x[..., 0], x[..., 1], x[..., 2], y[..., 0], y[..., 1], y[..., 2]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid &= ~(area.abs() < MIN_AREA)
    inv_area = torch.reciprocal(area)

    box_w = (maxx - minx + 1).clamp_min(0)
    count = torch.where(valid, box_w * (maxy - miny + 1), 0).reshape(-1)
    ends = torch.cumsum(count, 0)
    # Chunks of whole triangles with at most `chunk` pairs each (a larger
    # triangle is a chunk of its own).
    ends_host = ends.cpu().numpy()
    cuts = [0]
    while cuts[-1] < len(ends_host):
        base = ends_host[cuts[-1] - 1] if cuts[-1] else 0
        cuts.append(max(int(np.searchsorted(ends_host, base + chunk, side="right")), cuts[-1] + 1))
    per_tri = [t.reshape(-1) for t in (x0, x1, x2, y0, y1, y2, iz[..., 0], iz[..., 1], iz[..., 2], inv_area,
                                       minx, miny, box_w)]
    camera = torch.arange(C, device=device)[:, None].expand(valid.shape).reshape(-1)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        n = count[lo:hi]
        tri = torch.repeat_interleave(torch.arange(lo, hi, device=device), n)
        if tri.numel() == 0:
            continue
        local = torch.arange(tri.numel(), device=device) - (ends[tri] - count[tri] - (ends[lo] - count[lo]))
        tx0, tx1, tx2, ty0, ty1, ty2, iz0, iz1, iz2, inv, bx, by, bw = (t[tri] for t in per_tri)
        px = bx + local % bw
        py = by + local // bw
        pxc = px.to(torch.float32) + 0.5
        pyc = py.to(torch.float32) + 0.5
        w0 = ((tx1 - pxc) * (ty2 - pyc) - (tx2 - pxc) * (ty1 - pyc)) * inv
        w1 = ((tx2 - pxc) * (ty0 - pyc) - (tx0 - pxc) * (ty2 - pyc)) * inv
        w2 = (1.0 - w0) - w1
        depth = torch.reciprocal((w0 * iz0 + w1 * iz1) + w2 * iz2)
        keep = ~((w0 < 0) | (w1 < 0) | (w2 < 0)) & (depth < float("inf"))
        cam = camera[tri]
        pixel = offset[cam, 0] + py * width[cam, 0] + px
        buf.scatter_reduce_(0, pixel[keep], depth[keep], "amin")
        fragments += torch.bincount(cam[keep], minlength=C)
    return buf, fragments


def resolve(buf: torch.Tensor, params: CameraParams) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Flat depth buffer → per camera (mask uint8 0/255, depth float32 with
    0 where uncovered), each (H, W)."""
    covered = buf < float("inf")
    mask = covered.to(torch.uint8) * 255
    depth = torch.where(covered, buf, 0.0)
    out, start = [], 0
    for height, width in params.sizes:
        stop = start + height * width
        out.append((mask[start:stop].view(height, width), depth[start:stop].view(height, width)))
        start = stop
    return out


def rasterize_plain(vertices: torch.Tensor, faces: torch.Tensor, cameras: Sequence, scale: float = 1.0,
                    chunk: int = PLAIN_CHUNK) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """`rasterize` in eager PyTorch, on any device."""
    _check(vertices, faces)
    params = CameraParams.build(cameras, vertices.device)
    buf, _ = depth_buffer_plain(project_plain(vertices, params, scale), faces, params, chunk)
    return resolve(buf, params)


# ----------------------------------------------------------------- kernel


def _lib():
    lib = load_library("mesh_raster").lib
    if lib.mesh_project.argtypes is None:
        # vertices, V, cameras, C, scale, proj, stream.
        lib.mesh_project.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        lib.mesh_project.restype = ctypes.c_int
        # proj, V, faces, F, camera ints, C, zbuf, stream.
        lib.mesh_raster.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.mesh_raster.restype = ctypes.c_int
    return lib


def launch_project(vertices: torch.Tensor, params: CameraParams, scale: float) -> torch.Tensor:
    """`mesh_project` on the card: (V, 3) → (C, V, 4) as `project_plain`."""
    C, V = params.floats.shape[0], vertices.shape[0]
    proj = torch.empty((C, V, 4), dtype=torch.float32, device=vertices.device)
    if C * V == 0:
        return proj
    with torch.cuda.device(vertices.device):
        stream = torch.cuda.current_stream(vertices.device).cuda_stream
        err = _lib().mesh_project(vertices.contiguous().data_ptr(), V, params.floats.data_ptr(), C,
                                  float(np.float32(scale)), proj.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mesh_project launch failed at C={C}, V={V}: cudaError {err}")
    launches["project"] += 1
    return proj


def launch_raster(proj: torch.Tensor, faces: torch.Tensor, params: CameraParams) -> torch.Tensor:
    """`mesh_raster` on the card: (C, V, 4) projections → the flat float32
    depth buffer of `depth_buffer_plain` (+inf where nothing was drawn)."""
    C, V = proj.shape[:2]
    F = faces.shape[0]
    # The bits of +inf: a positive float's bits order as the float does,
    # so an integer atomicMin on them keeps the least depth.
    zbuf = torch.full((params.total,), 0x7F800000, dtype=torch.int32, device=proj.device)
    if C * F == 0:
        return zbuf.view(torch.float32)
    with torch.cuda.device(proj.device):
        stream = torch.cuda.current_stream(proj.device).cuda_stream
        err = _lib().mesh_raster(proj.data_ptr(), V, faces.contiguous().data_ptr(), F, params.ints.data_ptr(), C,
                                 zbuf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mesh_raster launch failed at C={C}, V={V}, F={F}: cudaError {err}")
    launches["raster"] += 1
    return zbuf.view(torch.float32)


def rasterize(vertices: torch.Tensor, faces: torch.Tensor, cameras: Sequence,
              scale: float = 1.0) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """vertices (V, 3) float32 and faces (F, 3) int32 (0-based) of one mesh,
    `cameras` (`toolbox.mesh_io.Camera`) → per camera (mask (H, W) uint8
    0/255, depth (H, W) float32, camera-space z, 0 where uncovered).

    CUDA tensors go through the kernels (one pass renders every camera),
    CPU tensors through `rasterize_plain`; anything else raises.
    """
    _check(vertices, faces)
    if vertices.device.type == "cpu":
        return rasterize_plain(vertices, faces, cameras, scale)
    params = CameraParams.build(cameras, vertices.device)
    return resolve(launch_raster(launch_project(vertices, params, scale), faces, params), params)
