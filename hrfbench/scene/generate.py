"""The r4 synthetic scene, frozen for the benchmark: a procedurally textured
sphere actor with thin rods, drifting over the frames, seen by a ring of
cameras, written in the ActorsHQ layout that the port's loader reads.

A copy of the port's generator (ray tracer, cameras, occupancy carver and
normalisation, in float32 torch), so a later change to the port cannot
change the benchmark's traffic. It differs in one respect: every image is
written losslessly as an 8-bit PNG (the colour images under their `.jpg`
names, which the port's reader tells apart by their signature), with numpy
and zlib alone, so the benchmark's reference can read back the exact pixels
without the port's JPEG codec.

    python -m hrfbench.scene.generate --root <dir> --width 96 --height 96
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

@dataclass
class SyntheticSceneConfig:
    num_cameras: int = 8
    width: int = 64
    height: int = 64
    num_frames: int = 2
    first_frame: int = 0
    sphere_radius: float = 0.35
    # The sphere's centre drifts linearly from `center_start` to `center_end`.
    center_start: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    center_end: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_distance: float = 3.0
    grid_resolution: int = 64
    # World-space half-extent margin of the per-frame AABBs.
    aabb_margin: float = 0.1
    focal: float = 1.2  # normalized focal length
    # Cameras whose width/height are swapped (portrait).
    portrait_camera_indices: Tuple[int, ...] = ()
    # Explicit camera azimuths in radians (override the uniform ring).
    camera_angles: Optional[Tuple[float, ...]] = None
    # Spatial frequency of the surface texture (~6 smooth, >= 30 fine detail).
    texture_frequency: float = 6.0
    # Thin capsule rods radiating from the sphere.
    num_rods: int = 0
    rod_radius: float = 0.02
    rod_length: float = 0.3


def _look_at_cam2world(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """RDF camera-to-world rotation: +z from eye toward target, +x right, +y down."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    world_up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(forward, world_up)) > 0.99:
        world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, -world_up)
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward], axis=1)


def make_cameras(cfg: SyntheticSceneConfig) -> List[Camera]:
    cameras = []
    center = np.array([0.0, 0.0, 0.0])
    angles = (
        list(cfg.camera_angles)
        if cfg.camera_angles is not None
        else [2 * np.pi * i / cfg.num_cameras for i in range(cfg.num_cameras)]
    )
    for i, angle in enumerate(angles):
        z = 0.4 * np.sin(2 * angle + 0.5)  # alternating elevation constrains the hull
        eye = np.array([cfg.camera_distance * np.cos(angle), cfg.camera_distance * np.sin(angle), z])
        R = _look_at_cam2world(eye, center)
        portrait = i in cfg.portrait_camera_indices
        width = cfg.height if portrait else cfg.width
        height = cfg.width if portrait else cfg.height
        cameras.append(
            Camera(
                name=f"Cam{i + 1:03d}",
                width=width,
                height=height,
                rotation_axisangle=Rotation.from_matrix(R).as_rotvec(),
                translation=eye,
                focal_length=np.array([cfg.focal, cfg.focal * width / height]),
                principal_point=np.array([0.5, 0.5]),
            )
        )
    return cameras


def _sphere_center(cfg: SyntheticSceneConfig, frame_idx: int) -> np.ndarray:
    t = frame_idx / max(cfg.num_frames - 1, 1)
    return (1 - t) * np.asarray(cfg.center_start) + t * np.asarray(cfg.center_end)


def _rod_directions(num_rods: int) -> np.ndarray:
    """Evenly spread unit directions (golden spiral) for the rods."""
    k = np.arange(num_rods) + 0.5
    phi = np.arccos(1 - 2 * k / num_rods)
    theta = np.pi * (1 + 5**0.5) * k
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis of length 3, as an explicit fp32 sum
    (no matmul, whose precision a global flag may change on the GPU)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def _sphere(origin, dirs, center, r):
    oc = origin - center
    b = 2.0 * _dot(dirs, oc[..., None, None, :])
    c = _dot(oc, oc)[..., None, None] - r * r
    disc = b * b - 4 * c
    t_hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0
    hit = (disc > 0) & (t_hit > 0)
    points = origin[..., None, None, :] + dirs * t_hit[..., None]
    return t_hit, hit, (points - center) / r


def _capsule(origin, dirs, p0, p1, r):
    axis = p1 - p0
    length = _norm(axis)
    axis = axis / length
    oc = origin - p0
    d_perp = dirs - _dot(dirs, axis)[..., None] * axis
    oc_perp = oc - _dot(oc, axis)[..., None] * axis
    a = _dot(d_perp, d_perp)
    b = 2.0 * _dot(d_perp, oc_perp[..., None, None, :])
    c = _dot(oc_perp, oc_perp)[..., None, None] - r * r
    disc = b * b - 4 * a * c
    t_cyl = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(2 * a, min=1e-12)
    along = _dot(origin[..., None, None, :] + dirs * t_cyl[..., None] - p0, axis)
    hit_cyl = (disc > 0) & (t_cyl > 0) & (along >= 0) & (along <= length)
    t_best = torch.where(hit_cyl, t_cyl, torch.inf)
    for cap in (p0, p1):
        t_s, hit_s, _ = _sphere(origin, dirs, cap, r)
        t_best = torch.where(hit_s & (t_s < t_best), t_s, t_best)
    hit = torch.isfinite(t_best)
    points = origin[..., None, None, :] + dirs * torch.where(hit, t_best, 0.0)[..., None]
    along = torch.clamp(_dot(points - p0, axis), 0.0, float(length))
    normals = points - (p0 + along[..., None] * axis)
    normals = normals / torch.clamp(_norm(normals)[..., None], min=1e-12)
    return t_best, hit, normals


@torch.no_grad()
def render_cameras(cfg: SyntheticSceneConfig, inv_krs: torch.Tensor, origins: torch.Tensor, center: torch.Tensor,
                   frame_phase: float, height: int, width: int):
    """Ray-trace the actor for a batch of same-size cameras, in float32 on
    the tensors' device (the JAX package's `_render_batch_jax`).

    inv_krs (C, 3, 3), origins (C, 3), center (3,) float32 →
    (rgb (C, H, W, 3) uint8 = round(rgb · 255), mask (C, H, W) uint8 {0, 1}).
    """
    device = inv_krs.device
    radius = float(cfg.sphere_radius)
    f = float(cfg.texture_frequency)
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px, py, torch.ones_like(px)], dim=-1)  # (H, W, 3)
    dirs = _dot(pix[None, :, :, None, :], inv_krs[:, None, None, :, :])  # (C, H, W, 3): pix @ inv_kr.T
    dirs = dirs / _norm(dirs)[..., None]
    origin = origins[:, None, None, :]

    t_best, hit_any, normals = _sphere(origins, dirs, center, radius)
    t_best = torch.where(hit_any, t_best, torch.inf)
    if cfg.num_rods:
        for rod_dir in _rod_directions(cfg.num_rods):
            rd = torch.tensor(rod_dir, dtype=torch.float32, device=device)
            p0 = center + rd * radius * 0.8
            p1 = center + rd * (radius + cfg.rod_length)
            t_r, hit_r, n_r = _capsule(origins, dirs, p0, p1, cfg.rod_radius)
            closer = hit_r & (t_r < t_best)
            t_best = torch.where(closer, t_r, t_best)
            normals = torch.where(closer[..., None], n_r, normals)
            hit_any = hit_any | hit_r
    hit = hit_any & torch.isfinite(t_best)

    points = origin + dirs * torch.where(hit, t_best, 0.0)[..., None]
    local = (points - center) / radius
    rgb = 0.5 + 0.5 * torch.stack(
        [
            torch.sin(f * local[..., 0] + frame_phase) * torch.cos(0.7 * f * local[..., 1]),
            torch.sin(f * local[..., 1] + 2.0 + frame_phase) * torch.cos(0.9 * f * local[..., 2]),
            torch.sin(f * local[..., 2] + 4.0) * torch.cos(0.8 * f * local[..., 0]),
        ],
        dim=-1,
    )
    light = torch.tensor([0.5, 0.5, 0.7], dtype=torch.float32, device=device)
    light = light / _norm(light)
    shade = torch.clamp(_dot(normals, light), 0.2, 1.0)
    rgb = torch.clamp(rgb * shade[..., None], 0.0, 1.0)
    rgb = torch.where(hit[..., None], rgb, 0.0)
    return torch.round(rgb * 255.0).to(torch.uint8), hit.to(torch.uint8)


@torch.no_grad()
def occupancy_grid(cfg: SyntheticSceneConfig, center_scaled: np.ndarray, scene_scale: float, device) -> np.ndarray:
    """Occupancy grid over the canonical [-0.5, 0.5] cube, 255 inside the
    actor dilated by 1.5 voxels, 0 elsewhere; [z][y][x] with corner-aligned
    voxel coordinates i/(res-1) − 0.5 (the JAX package's `_occupancy_grid`,
    the same float32 distance tests)."""
    res = cfg.grid_resolution
    coords = np.arange(res) / (res - 1) - 0.5
    gz, gy, gx = np.meshgrid(coords, coords, coords, indexing="ij")
    flat = torch.tensor(np.stack([gx, gy, gz], axis=-1).astype(np.float32).reshape(-1, 3), device=device)
    dilation = 1.5 / res
    radius_scaled = cfg.sphere_radius * scene_scale
    rod_dirs = _rod_directions(cfg.num_rods) if cfg.num_rods else np.zeros((0, 3))
    p0s = torch.tensor((center_scaled + rod_dirs * radius_scaled * 0.8).astype(np.float32), device=device)
    p1s = torch.tensor(
        (center_scaled + rod_dirs * (cfg.sphere_radius + cfg.rod_length) * scene_scale).astype(np.float32), device=device
    )
    center = torch.tensor(center_scaled.astype(np.float32), device=device)
    sphere_r = torch.tensor(np.float32(radius_scaled + dilation), device=device)
    rod_r = torch.tensor(np.float32(cfg.rod_radius * scene_scale + dilation), device=device)

    inside = _norm(flat - center) <= sphere_r
    for i in range(p0s.shape[0]):
        p0, p1 = p0s[i], p1s[i]
        axis = p1 - p0
        denom = torch.clamp(_dot(axis, axis), min=1e-12)
        along = torch.clamp(_dot(flat - p0, axis) / denom, 0.0, 1.0)
        inside |= _norm(flat - (p0 + along[:, None] * axis)) <= rod_r
    grid = torch.where(inside, 255, 0).to(torch.uint8)
    return grid.reshape(res, res, res).cpu().numpy()




@dataclass
class Camera:
    """One camera of the calibration CSV (``name,w,h,rx,ry,rz,tx,ty,tz,fx,fy,px,py``):
    axis-angle cam2world rotation, position, intrinsics normalized by width/height."""

    name: str
    width: int
    height: int
    rotation_axisangle: np.ndarray
    translation: np.ndarray
    focal_length: np.ndarray
    principal_point: np.ndarray

    def inverse_kr(self) -> np.ndarray:
        """3x3 map from homogeneous pixel coordinates (x + 0.5, y + 0.5, 1) to a world ray direction."""
        k = np.array([
            [self.width * self.focal_length[0], 0.0, self.width * self.principal_point[0]],
            [0.0, self.height * self.focal_length[1], self.height * self.principal_point[1]],
            [0.0, 0.0, 1.0],
        ])
        cam2world = np.eye(4)
        cam2world[:3, :3] = Rotation.from_rotvec(self.rotation_axisangle).as_matrix()
        cam2world[:3, 3] = self.translation
        projection = np.eye(4)
        projection[:3] = k @ np.linalg.inv(cam2world)[:3]
        return np.linalg.inv(projection)[:3, :3]


CSV_COLUMNS = ["name", "w", "h", "rx", "ry", "rz", "tx", "ty", "tz", "fx", "fy", "px", "py"]
AABB_COLUMNS = ["frame_number"] + [f"aabb_{c}_{a}" for c in ("min", "max") for a in "xyz"]


def write_calibration_csv(cameras: List[Camera], path: Path) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_COLUMNS)
        for c in cameras:
            writer.writerow([c.name, c.width, c.height, *c.rotation_axisangle, *c.translation, *c.focal_length,
                             *c.principal_point])


def read_calibration_csv(path: Path) -> List[Camera]:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return [Camera(r["name"], int(r["w"]), int(r["h"]), np.array([float(r[k]) for k in ("rx", "ry", "rz")]),
                   np.array([float(r[k]) for k in ("tx", "ty", "tz")]), np.array([float(r["fx"]), float(r["fy"])]),
                   np.array([float(r["px"]), float(r["py"])])) for r in rows]


def read_aabbs_csv(path: Path) -> np.ndarray:
    """→ (frames, 2, 3) float64, in the file's row order."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r[c]) for c in AABB_COLUMNS[1:]] for r in rows]).reshape(-1, 2, 3)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 → PNG bytes (filter None, zlib level 1)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    color = 0 if img.ndim == 2 else 2
    height, width = img.shape[:2]
    raw = np.concatenate([np.zeros((height, 1), np.uint8), img.reshape(height, -1)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return b"".join([b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(raw, 1)), chunk(b"IEND", b"")])


def decode_png(data: bytes) -> np.ndarray:
    """What `encode_png` wrote → (H, W) or (H, W, 3) uint8; any other PNG raises."""
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    channels = {0: 1, 2: 3}.get(color)
    if data[:8] != b"\x89PNG\r\n\x1a\n" or depth != 8 or channels is None:
        raise ValueError("not a PNG written by encode_png")
    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, 1 + width * channels)
    if rows[:, 0].any():
        raise ValueError("a PNG row with a filter other than None")
    img = rows[:, 1:].reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def scene_paths(root: Path):
    """→ (sequence folder, data folder) of the scene under `root`."""
    seq = Path(root) / "SynthActor" / "Sequence1"
    return seq, seq / "1x"


def rgb_path(data_dir: Path, camera: str, frame: int) -> Path:
    return data_dir / "rgbs" / camera / f"{camera}_rgb{frame:06d}.jpg"


def mask_path(data_dir: Path, camera: str, frame: int) -> Path:
    return data_dir / "masks" / camera / f"{camera}_mask{frame:06d}.png"


def grid_path(seq_dir: Path, frame: int) -> Path:
    return seq_dir / "occupancy_grids" / f"occupancy_grid{frame:06d}.npz"


def generate(root: Path, cfg: SyntheticSceneConfig, device=None) -> Path:
    """Write the scene under root/SynthActor/Sequence1/{1x, aabbs.csv,
    occupancy_grids, scene.json}, rendering on `device` → the data folder."""
    device = torch.device(device or "cpu")
    seq_dir, data_dir = scene_paths(root)
    data_dir.mkdir(parents=True, exist_ok=True)
    (seq_dir / "occupancy_grids").mkdir(exist_ok=True)
    cameras = make_cameras(cfg)
    write_calibration_csv(cameras, data_dir / "calibration.csv")
    frames = list(range(cfg.first_frame, cfg.first_frame + cfg.num_frames))

    extent = cfg.sphere_radius + (cfg.rod_length + cfg.rod_radius if cfg.num_rods else 0.0)
    aabbs = []
    for fi in range(len(frames)):
        center = _sphere_center(cfg, fi)
        r = extent + cfg.aabb_margin
        aabbs.append(np.stack([center - r, center + r], axis=0))
    with open(seq_dir / "aabbs.csv", "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(AABB_COLUMNS)
        for fn, box in zip(frames, aabbs):
            writer.writerow([str(fn), *[str(v) for v in np.asarray(box).reshape(6)]])
    aabbs = read_aabbs_csv(seq_dir / "aabbs.csv")
    union = np.stack((aabbs[:, 0].min(0), aabbs[:, 1].max(0)), axis=0)
    scene_offset = -union.mean(0)
    scene_scale = 1.0 / np.max(union[1] - union[0])

    groups: dict = {}
    for cam in cameras:
        groups.setdefault((cam.height, cam.width), []).append(cam)
    inv = {hw: torch.tensor(np.stack([c.inverse_kr() for c in cams]).astype(np.float32), device=device)
           for hw, cams in groups.items()}
    org = {hw: torch.tensor(np.stack([c.translation for c in cams]).astype(np.float32), device=device)
           for hw, cams in groups.items()}
    for fi, fn in enumerate(frames):
        center = _sphere_center(cfg, fi)
        center32 = torch.tensor(center.astype(np.float32), device=device)
        for hw, cams in groups.items():
            rgbs, masks = render_cameras(cfg, inv[hw], org[hw], center32, 0.5 * fi, hw[0], hw[1])
            rgbs, masks = rgbs.cpu().numpy(), masks.cpu().numpy()
            for ci, cam in enumerate(cams):
                for path, img in ((rgb_path(data_dir, cam.name, fn), rgbs[ci]),
                                  (mask_path(data_dir, cam.name, fn), masks[ci] * 255)):
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_bytes(encode_png(img))
        grid = occupancy_grid(cfg, (center + scene_offset) * scene_scale, scene_scale, device)
        np.savez_compressed(str(grid_path(seq_dir, fn)), occupancy_grid=grid)
    (data_dir / "light_annotations.csv").write_text("camera,x,y,r\n")
    (seq_dir / "scene.json").write_text(json.dumps({"name": "SynthActor", "num_frames": cfg.num_frames,
                                                    "synthetic": True}))
    return data_dir


def scene_config(params: dict) -> SyntheticSceneConfig:
    """A configuration file's `scene` object → the generator's settings (lists become tuples)."""
    return SyntheticSceneConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in params.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--width", type=int, default=748)
    ap.add_argument("--height", type=int, default=748)
    ap.add_argument("--frames", type=int, default=50)
    args = ap.parse_args()
    cfg = dataclasses.replace(R4_SCENE, width=args.width, height=args.height, num_frames=args.frames)
    print(generate(args.root, cfg))


R4_SCENE = SyntheticSceneConfig(
    num_cameras=12, width=748, height=748, num_frames=50, sphere_radius=0.3, center_start=(0.0, 0.0, -0.08),
    center_end=(0.0, 0.0, 0.08), grid_resolution=128, texture_frequency=30.0, num_rods=12, rod_radius=0.015,
    rod_length=0.25,
)

if __name__ == "__main__":
    main()
