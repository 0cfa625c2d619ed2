"""Synthetic ActorsHQ-format dataset generator.

Counterpart of `humanrf_tpu/core/synthetic.py`: a procedurally textured
sphere "actor" (with optional thin capsule rods) that drifts over the
frames, seen by cameras on a circle, written in the ActorsHQ layout, so the
whole pipeline (loader → training → evaluation) runs without downloaded
data. The analytic ray tracer and the occupancy carver run as float32 torch
on a chosen device (the JAX package jits them); images go through the port's
codec: JPEG at q98 and PNG masks, the files cv2 would write.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from humanrf_torch.core import image_io
from humanrf_torch.core.aabb import AabbData, write_aabbs_csv
from humanrf_torch.core.camera import CameraData, write_calibration_csv


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


def make_cameras(cfg: SyntheticSceneConfig) -> List[CameraData]:
    from scipy.spatial.transform import Rotation

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
            CameraData(
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


def _ring_mesh(centers: np.ndarray, thetas: np.ndarray, axis: np.ndarray, radius: float, segments: int):
    """A closed surface of rings between two poles: ring k is the circle of
    polar angle thetas[k] about `axis` around centers[k]; the poles sit at
    centers[0] + r·axis and centers[-1] − r·axis. → (vertices, faces)."""
    u = np.cross(axis, [1.0, 0.0, 0.0] if abs(axis[0]) < 0.9 else [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    phi = 2 * np.pi * np.arange(segments) / segments
    around = np.cos(phi)[:, None] * u + np.sin(phi)[:, None] * v  # (S, 3)
    rings = centers[:, None] + radius * (np.sin(thetas)[:, None, None] * around + np.cos(thetas)[:, None, None] * axis)
    vertices = np.concatenate([[centers[0] + radius * axis], rings.reshape(-1, 3), [centers[-1] - radius * axis]])
    j, k = np.arange(segments), (np.arange(segments) + 1) % segments
    last = 1 + len(thetas) * segments
    faces = [np.stack([np.zeros(segments, int), 1 + j, 1 + k], 1)]
    for ring in range(len(thetas) - 1):
        a, b = 1 + ring * segments, 1 + (ring + 1) * segments
        faces += [np.stack([a + j, b + j, a + k], 1), np.stack([a + k, b + j, b + k], 1)]
    faces.append(np.stack([np.full(segments, last), last - segments + k, last - segments + j], 1))
    return vertices, np.concatenate(faces)


def subject_mesh(cfg: SyntheticSceneConfig, frame_idx: int, sphere_rings: int = 128, sphere_segments: int = 384,
                 rod_rings: int = 8, rod_segments: int = 32):
    """The actor of frame `frame_idx` as a triangle mesh on the analytic
    shapes of `render_cameras`: a UV sphere, and each rod as a capsule (a
    cylinder from p0 to p1 capped by half-spheres), `rod_rings` rings per cap.
    The defaults give 109,824 triangles with 12 rods. → (vertices (V, 3)
    float32, faces (F, 3) int32), the parts overlapping as the shapes do."""
    center = _sphere_center(cfg, frame_idx)
    parts = [_ring_mesh(np.repeat(center[None], sphere_rings - 1, 0),
                        np.pi * np.arange(1, sphere_rings) / sphere_rings, np.array([0.0, 0.0, 1.0]),
                        cfg.sphere_radius, sphere_segments)]
    cap = 0.5 * np.pi * np.arange(1, rod_rings + 1) / rod_rings
    for rod_dir in _rod_directions(cfg.num_rods) if cfg.num_rods else ():
        p0 = center + rod_dir * cfg.sphere_radius * 0.8
        p1 = center + rod_dir * (cfg.sphere_radius + cfg.rod_length)
        centers = np.concatenate([np.repeat(p1[None], rod_rings, 0), np.repeat(p0[None], rod_rings, 0)])
        parts.append(_ring_mesh(centers, np.concatenate([cap, np.pi - cap[::-1]]), rod_dir, cfg.rod_radius,
                                rod_segments))
    vertices, faces, base = [], [], 0
    for v, f in parts:
        vertices.append(v)
        faces.append(f + base)
        base += len(v)
    return np.concatenate(vertices).astype(np.float32), np.concatenate(faces).astype(np.int32)


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


def generate_synthetic_dataset(
    root: Path,
    cfg: SyntheticSceneConfig | None = None,
    actor: str = "SynthActor",
    sequence: str = "Sequence1",
    scale: int = 1,
    device=None,
) -> Path:
    """Write the dataset under root/<actor>/<sequence>/{<scale>x, aabbs.csv,
    occupancy_grids, scene.json}, rendering on `device` (default CPU).
    Returns the `<scale>x` data folder."""
    cfg = cfg or SyntheticSceneConfig()
    device = torch.device(device or "cpu")
    seq_dir = Path(root) / actor / sequence
    data_dir = seq_dir / f"{scale}x"
    data_dir.mkdir(parents=True, exist_ok=True)
    (seq_dir / "occupancy_grids").mkdir(exist_ok=True)

    cameras = make_cameras(cfg)
    write_calibration_csv(cameras, data_dir / "calibration.csv")
    frame_numbers = list(range(cfg.first_frame, cfg.first_frame + cfg.num_frames))

    aabbs = []
    actor_extent = cfg.sphere_radius + (cfg.rod_length + cfg.rod_radius if cfg.num_rods else 0.0)
    for fi, fn in enumerate(frame_numbers):
        center = _sphere_center(cfg, fi)
        r = actor_extent + cfg.aabb_margin
        aabbs.append(AabbData(frame_number=fn, aabb=np.stack([center - r, center + r], axis=0)))
    write_aabbs_csv(aabbs, seq_dir / "aabbs.csv")

    # Scene normalization (the loader's formula) places the grids in the cube.
    all_aabbs = np.stack([a.aabb for a in aabbs], axis=0)
    union = np.stack((all_aabbs[:, 0].min(0), all_aabbs[:, 1].max(0)), axis=0)
    scene_offset = -union.mean(0)
    scene_scale = 1.0 / np.max(union[1] - union[0])

    shape_groups: dict = {}
    for cam in cameras:
        shape_groups.setdefault((cam.height, cam.width), []).append(cam)
    group_inv = {
        hw: torch.tensor(np.stack([c.inverse_kr() for c in cams]).astype(np.float32), device=device)
        for hw, cams in shape_groups.items()
    }
    group_org = {
        hw: torch.tensor(np.stack([c.translation for c in cams]).astype(np.float32), device=device)
        for hw, cams in shape_groups.items()
    }
    for fi, fn in enumerate(frame_numbers):
        center = _sphere_center(cfg, fi)
        center32 = torch.tensor(center.astype(np.float32), device=device)
        for hw, cams in shape_groups.items():
            rgbs, masks = render_cameras(cfg, group_inv[hw], group_org[hw], center32, 0.5 * fi, hw[0], hw[1])
            rgbs, masks = rgbs.cpu().numpy(), masks.cpu().numpy()
            for ci, cam in enumerate(cams):
                rgb_dir = data_dir / "rgbs" / cam.name
                mask_dir = data_dir / "masks" / cam.name
                rgb_dir.mkdir(parents=True, exist_ok=True)
                mask_dir.mkdir(parents=True, exist_ok=True)
                image_io.imwrite(rgb_dir / f"{cam.name}_rgb{fn:06d}.jpg", rgbs[ci][..., ::-1], quality=98)
                image_io.imwrite(mask_dir / f"{cam.name}_mask{fn:06d}.png", masks[ci] * 255)
        center_scaled = (center + scene_offset) * scene_scale
        grid = occupancy_grid(cfg, center_scaled, scene_scale, device)
        np.savez_compressed(str(seq_dir / "occupancy_grids" / f"occupancy_grid{fn:06d}.npz"), occupancy_grid=grid)

    # Empty light annotations (schema presence only).
    with open(data_dir / "light_annotations.csv", "w") as f:
        f.write("camera,x,y,r\n")
    with open(seq_dir / "scene.json", "w") as f:
        json.dump({"name": actor, "num_frames": cfg.num_frames, "synthetic": True}, f)
    return data_dir
