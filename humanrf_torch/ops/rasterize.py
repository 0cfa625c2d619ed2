"""Triangle rasterization into per-camera masks and depth maps.

Counterpart of `render_camera` in `humanrf_tpu/native/mesh_renderer/main.cpp`
(:227-285), the JAX package's host C++ rasterizer (a TPU cannot rasterize;
the reference renders its masks with OpenGL on the GPU). For CUDA tensors
`rasterize` launches the hand-written kernels of `humanrf_torch/csrc/
mesh_raster.cu`; for CPU tensors it runs `rasterize_plain`, the same
arithmetic in eager PyTorch. There is no fallback: a CUDA call that cannot
build or launch raises.

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

Every camera's image lies in flat buffers at its own offset, so cameras of
different sizes share one pass. On the card a frame takes four launches:
`mesh_project` (every vertex in every camera), `mesh_bin` twice (each
drawn triangle listed in the TILE × TILE screen tiles its box touches:
counts and their prefix sum, then the lists) and `mesh_raster` (a block per
tile and CHUNK of its triangles, the tile's depth in shared memory, each
pixel's mask and depth written once); one host read per frame sizes the
lists.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from humanrf_torch.ops.cuda_build import load_library

# Kernel launches since the last reset, per kernel (each wrapper adds one
# where it launches its kernel): per frame on the card one "project", two
# "bin" and one "raster".
launches = {"project": 0, "bin": 0, "raster": 0}

NEAR = float(np.float32(1e-6))  # the tool's near clip, 1e-6f
MIN_AREA = float(np.float32(1e-12))
INT_MIN = -(2**31)
INT32_MAX = 2**31 - 1
PLAIN_CHUNK = 1 << 22  # (triangle, box pixel) pairs per step of the plain version
# The kernels' tiles: 64 × 64 pixels, 16 KB of int32 depth in shared memory.
TILE_LOG2 = 6
TILE = 1 << TILE_LOG2
# Box pixels (within a tile) that one thread walks; a warp walks a larger
# box over its row ranges. The r4 subject's boxes: 99% hold ≤ 20 pixels at
# 748² and ≤ 176 at 4112 × 3008; above 256 lie only its rods' thin sides
# (0.7% of the triangles: 58% and 83% of all box pixels), at both sizes.
SMALL_BOX = 256
# Listed triangles per raster block: a tile with more ("crowded", up to 22k
# at 748²) is split over blocks that merge through a depth buffer of the
# tile in device memory, so that no one block walks a long list alone.
CHUNK = 1024
LIBRARY_DEFINES = (f"MESH_TILE_LOG2={TILE_LOG2}", f"MESH_SMALL_BOX={SMALL_BOX}", f"MESH_CHUNK={CHUNK}")
MAX_CAMERAS = 65535  # a grid's y dimension
MAX_SIDE = 1 << 22  # pixel centres x + 0.5 stay exact in float32, stepped by 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass
class CameraParams:
    """The cameras as the kernels read them. `floats` (C, 16) float32: the
    world-to-camera rotation Rᵀ row-major (9), the translation (3), fx·W,
    fy·H, cx·W, cy·H; `ints` (C, 6) int64: W, H, the image's offset in the
    flat buffers of `total` pixels, its tiles across and down, and its first
    tile's index among all `tiles`; `max_tiles`, the most of one camera."""

    floats: torch.Tensor
    ints: torch.Tensor
    sizes: List[Tuple[int, int]]  # (H, W) per camera
    total: int
    tiles: int
    max_tiles: int

    @classmethod
    def build(cls, cameras: Sequence, device) -> "CameraParams":
        """`cameras`: `toolbox.mesh_io.Camera`s (float32 calibration)."""
        floats = np.zeros((len(cameras), 16), dtype=np.float32)
        ints = np.zeros((len(cameras), 6), dtype=np.int64)
        offset = tiles = max_tiles = 0
        for i, cam in enumerate(cameras):
            if not (0 < cam.width <= MAX_SIDE and 0 < cam.height <= MAX_SIDE):
                raise ValueError(f"{cam.name}: images of 1 to {MAX_SIDE} pixels a side, got {cam.width}x{cam.height}")
            width, height = np.float32(cam.width), np.float32(cam.height)
            floats[i, :9] = np.asarray(cam.rotation, dtype=np.float32).T.reshape(-1)
            floats[i, 9:12] = cam.translation
            floats[i, 12:] = [cam.fx * width, cam.fy * height, cam.cx * width, cam.cy * height]
            across, down = -(-cam.width // TILE), -(-cam.height // TILE)
            ints[i] = (cam.width, cam.height, offset, across, down, tiles)
            offset += cam.width * cam.height
            tiles += across * down
            max_tiles = max(max_tiles, across * down)
        return cls(torch.tensor(floats, device=device), torch.tensor(ints, device=device),
                   [(cam.height, cam.width) for cam in cameras], offset, tiles, max_tiles)


@dataclass
class Bins:
    """The tile lists: tile t lists entries[offsets[t]:offsets[t + 1]] (int32,
    face indices); a crowded tile (more than CHUNK faces) has its depth
    buffer at slots[t] of `crowded`; `most`, the most faces of one tile."""

    offsets: torch.Tensor
    entries: torch.Tensor
    slots: torch.Tensor
    crowded: int
    most: int


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
    if vertices.shape[0] > INT32_MAX or faces.shape[0] > INT32_MAX:
        raise ValueError(f"at most 2^31 - 1 vertices and faces, got {vertices.shape[0]} and {faces.shape[0]}")
    if faces.numel():
        low, high = torch.stack(torch.aminmax(faces)).tolist()  # one host read
        if low < 0 or high >= vertices.shape[0]:
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


def setup_plain(proj: torch.Tensor, faces: torch.Tensor, params: CameraParams) -> dict:
    """The per-triangle setup of every (camera, face), each (C, F): `valid`
    (the tool draws it), the box `minx`, `maxx`, `miny`, `maxy` (int64), the
    corners `x0`..`y2`, `iz0`..`iz2` and `inv_area`."""
    corners = proj[:, faces.long()]  # (C, F, 3, 4)
    x, y, z, iz = (corners[..., k] for k in range(4))
    width, height = params.ints[:, 0, None], params.ints[:, 1, None]
    valid = ~((z[..., 0] <= NEAR) | (z[..., 1] <= NEAR) | (z[..., 2] <= NEAR))  # a NaN z is not clipped
    minx = _to_int_x86(torch.floor(_min3(x[..., 0], x[..., 1], x[..., 2]))).clamp_min(0)
    maxx = torch.minimum(_to_int_x86(torch.ceil(_max3(x[..., 0], x[..., 1], x[..., 2]))), width - 1)
    miny = _to_int_x86(torch.floor(_min3(y[..., 0], y[..., 1], y[..., 2]))).clamp_min(0)
    maxy = torch.minimum(_to_int_x86(torch.ceil(_max3(y[..., 0], y[..., 1], y[..., 2]))), height - 1)
    valid &= (minx <= maxx) & (miny <= maxy)
    x0, x1, x2, y0, y1, y2 = x[..., 0], x[..., 1], x[..., 2], y[..., 0], y[..., 1], y[..., 2]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid &= ~(area.abs() < MIN_AREA)
    return {"valid": valid, "minx": minx, "maxx": maxx, "miny": miny, "maxy": maxy, "x0": x0, "x1": x1, "x2": x2,
            "y0": y0, "y1": y1, "y2": y2, "iz0": iz[..., 0], "iz1": iz[..., 1], "iz2": iz[..., 2],
            "inv_area": torch.reciprocal(area)}


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
    s = setup_plain(proj, faces, params)
    width, offset = params.ints[:, 0, None], params.ints[:, 2, None]
    box_w = (s["maxx"] - s["minx"] + 1).clamp_min(0)
    count = torch.where(s["valid"], box_w * (s["maxy"] - s["miny"] + 1), 0).reshape(-1)
    ends = torch.cumsum(count, 0)
    # Chunks of whole triangles with at most `chunk` pairs each (a larger
    # triangle is a chunk of its own).
    ends_host = ends.cpu().numpy()
    cuts = [0]
    while cuts[-1] < len(ends_host):
        base = ends_host[cuts[-1] - 1] if cuts[-1] else 0
        cuts.append(max(int(np.searchsorted(ends_host, base + chunk, side="right")), cuts[-1] + 1))
    per_tri = [s[k].reshape(-1) for k in ("x0", "x1", "x2", "y0", "y1", "y2", "iz0", "iz1", "iz2", "inv_area",
                                          "minx", "miny")] + [box_w.reshape(-1)]
    camera = torch.arange(C, device=device)[:, None].expand(s["valid"].shape).reshape(-1)
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


def bin_plain(proj: torch.Tensor, faces: torch.Tensor, params: CameraParams) -> Bins:
    """The plain tile lists of (C, V, 4) projections: each tile lists the
    faces drawn in its camera whose box touches it, in ascending order (the
    kernel lists them in any order)."""
    device = proj.device
    C, F = proj.shape[0], faces.shape[0]
    count = torch.zeros(params.tiles, dtype=torch.int64, device=device)
    entries = torch.zeros(0, dtype=torch.int32, device=device)
    if C and F:
        s = setup_plain(proj, faces, params)
        tx0, ty0 = s["minx"] >> TILE_LOG2, s["miny"] >> TILE_LOG2
        across = torch.where(s["valid"], (s["maxx"] >> TILE_LOG2) - tx0 + 1, 0).reshape(-1)
        down = torch.where(s["valid"], (s["maxy"] >> TILE_LOG2) - ty0 + 1, 0).reshape(-1)
        pairs = across * down
        job = torch.repeat_interleave(torch.arange(C * F, device=device), pairs)
        local = torch.arange(job.numel(), device=device) - (torch.cumsum(pairs, 0) - pairs)[job]
        cam = job // F
        tile = (params.ints[cam, 5] + (ty0.reshape(-1)[job] + local // across[job]) * params.ints[cam, 3]
                + tx0.reshape(-1)[job] + local % across[job])
        entries = (torch.sort(tile * F + job % F)[0] % F).to(torch.int32)
        count = torch.bincount(tile, minlength=params.tiles)
    offsets = torch.zeros(params.tiles + 1, dtype=torch.int32, device=device)
    offsets[1:] = torch.cumsum(count, 0)
    crowded = (count > CHUNK).to(torch.int32)
    slots = (torch.cumsum(crowded, 0) - crowded).to(torch.int32)
    return Bins(offsets, entries, slots, int(crowded.sum()), int(count.max()) if count.numel() else 0)


def resolve(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat depth buffer (+inf where uncovered) → flat (mask uint8 0/255,
    depth float32 with 0 where uncovered)."""
    covered = buf < float("inf")
    return covered.to(torch.uint8) * 255, torch.where(covered, buf, 0.0)


def views(mask: torch.Tensor, depth: torch.Tensor, params: CameraParams) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Flat mask and depth → per camera (mask, depth), each an (H, W) view."""
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
    return views(*resolve(buf), params)


# ----------------------------------------------------------------- kernel


def _lib():
    lib = load_library("mesh_raster", LIBRARY_DEFINES).lib
    if lib.mesh_project.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # vertices, V, cameras, C, scale, proj, stream.
        lib.mesh_project.argtypes = [ptr, i32, ptr, i32, ctypes.c_float, ptr, ptr]
        # proj, V, faces, F, camera ints, C, tiles, counts, offsets, slots, entries, scratch, fill, out, stream.
        lib.mesh_bin.argtypes = [ptr, i32, ptr, i32, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr]
        # proj, V, faces, camera ints, C, max tiles, most, offsets, slots, entries, crowded, crowd z,
        # crowd done, mask, depth, stream.
        lib.mesh_raster.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr]
        for fn in (lib.mesh_project, lib.mesh_bin, lib.mesh_raster):
            fn.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _check_cameras(params: CameraParams) -> None:
    if params.floats.shape[0] > MAX_CAMERAS:
        raise ValueError(f"at most {MAX_CAMERAS} cameras per call, got {params.floats.shape[0]}")


def launch_project(vertices: torch.Tensor, params: CameraParams, scale: float) -> torch.Tensor:
    """`mesh_project` on the card: (V, 3) → (C, V, 4) as `project_plain`."""
    _check_cameras(params)
    C, V = params.floats.shape[0], vertices.shape[0]
    proj = torch.empty((C, V, 4), dtype=torch.float32, device=vertices.device)
    if C * V == 0:
        return proj
    with torch.cuda.device(vertices.device):
        _raise_on(_lib().mesh_project(vertices.contiguous().data_ptr(), V, params.floats.data_ptr(), C,
                                      float(np.float32(scale)), proj.data_ptr(), _stream(vertices.device)),
                  f"mesh_project at C={C}, V={V}")
    launches["project"] += 1
    return proj


def launch_bin(proj: torch.Tensor, faces: torch.Tensor, params: CameraParams) -> Bins:
    """`mesh_bin` on the card, twice: (C, V, 4) projections → the tile
    lists of `bin_plain` (each tile's faces in any order). The first launch
    counts and sums, and the host reads the lists' length (the frame's one
    wait on the card); the second writes the lists."""
    _check_cameras(params)
    C, V = proj.shape[:2]
    F = faces.shape[0]
    device = proj.device
    if C * F == 0 or params.tiles == 0:
        return bin_plain(proj, faces[:0], params)  # empty lists: nothing to launch
    counts, slots = (torch.empty(params.tiles, dtype=torch.int32, device=device) for _ in range(2))
    offsets = torch.empty(params.tiles + 1, dtype=torch.int32, device=device)
    scratch = torch.empty(3, dtype=torch.int64, device=device)
    faces = faces.contiguous()
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        lib, stream = _lib(), _stream(device)
        args = (proj.data_ptr(), V, faces.data_ptr(), F, params.ints.data_ptr(), C, params.tiles, counts.data_ptr(),
                offsets.data_ptr(), slots.data_ptr())
        _raise_on(lib.mesh_bin(*args, None, scratch.data_ptr(), 0, out, stream), f"mesh_bin (counts) at C={C}, F={F}")
        launches["bin"] += 1
        total, crowded, most = out
        if total > INT32_MAX:
            raise ValueError(f"{total} (triangle, tile) pairs, more than the int32 lists hold")
        entries = torch.empty(total, dtype=torch.int32, device=device)
        _raise_on(lib.mesh_bin(*args, entries.data_ptr(), scratch.data_ptr(), 1, None, stream),
                  f"mesh_bin (lists) at C={C}, F={F}")
    launches["bin"] += 1
    return Bins(offsets, entries, slots, crowded, most)


def launch_raster(proj: torch.Tensor, faces: torch.Tensor, params: CameraParams,
                  bins: Bins) -> Tuple[torch.Tensor, torch.Tensor]:
    """`mesh_raster` on the card: the projections and the tile lists →
    flat (mask, depth) as `resolve` of `depth_buffer_plain`'s buffer."""
    _check_cameras(params)
    C, V = proj.shape[:2]
    device = proj.device
    mask = torch.empty(params.total, dtype=torch.uint8, device=device)
    depth = torch.empty(params.total, dtype=torch.float32, device=device)
    if params.total == 0:
        return mask, depth
    crowd_z = torch.empty((bins.crowded, TILE * TILE), dtype=torch.int32, device=device)
    crowd_done = torch.empty(bins.crowded, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _raise_on(_lib().mesh_raster(proj.data_ptr(), V, faces.contiguous().data_ptr(), params.ints.data_ptr(), C,
                                     params.max_tiles, bins.most, bins.offsets.data_ptr(), bins.slots.data_ptr(),
                                     bins.entries.data_ptr(), bins.crowded, crowd_z.data_ptr(), crowd_done.data_ptr(),
                                     mask.data_ptr(), depth.data_ptr(), _stream(device)),
                  f"mesh_raster at C={C}, V={V}")
    launches["raster"] += 1
    return mask, depth


def rasterize(vertices: torch.Tensor, faces: torch.Tensor, cameras: Sequence,
              scale: float = 1.0) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """vertices (V, 3) float32 and faces (F, 3) int32 (0-based) of one mesh,
    `cameras` (`toolbox.mesh_io.Camera`) → per camera (mask (H, W) uint8
    0/255, depth (H, W) float32, camera-space z, 0 where uncovered).

    CUDA tensors go through the kernels (one pass renders every camera:
    `mesh_project`, `mesh_bin` twice, `mesh_raster`), CPU tensors through
    the plain version; anything else raises.
    """
    if vertices.device.type == "cpu":
        return rasterize_plain(vertices, faces, cameras, scale)
    _check(vertices, faces)
    params = CameraParams.build(cameras, vertices.device)
    proj = launch_project(vertices, params, scale)
    return views(*launch_raster(proj, faces, params, launch_bin(proj, faces, params)), params)
