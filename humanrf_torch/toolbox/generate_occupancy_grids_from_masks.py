#!/usr/bin/env python3
"""Occupancy-grid generation by visual-hull carving from masks.

Counterpart of `humanrf_tpu/toolbox/generate_occupancy_grids_from_masks.py`
(the reference ran it as a CUDA kernel): every voxel centre of a res³ grid
over the normalized scene cube is projected into every camera; a voxel is
occupied (255) when at least `camera_coverage_threshold` cameras see it in
front of them with a non-zero mask pixel in the 2×2 neighbourhood from
floor(px), floor(py). The masks are dilated first by a square of side
max(W, H) // 128 (`core/morphology.dilate`, OpenCV's dilation).

`_carve` runs in torch on the caller's device, one chunk of voxels at a
time. Its projection rounds as the JAX tool's does on the CPU (`_project`),
so that a voxel whose projection lands within an ulp of a pixel edge falls
on the same side in both, and every op is a separate torch op, so the CPU
and the GPU give the same grid bit for bit. The command line carves on
the GPU by default; `--device cpu` runs it on the CPU.

    python -m humanrf_torch.toolbox.generate_occupancy_grids_from_masks \\
        --data_folder <actor>/<sequence>/<scale>x --grid_resolution 256 --camera_coverage_threshold 150
"""
from __future__ import annotations

import argparse
import multiprocessing
from multiprocessing.pool import ThreadPool
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from humanrf_torch.core import morphology
from humanrf_torch.core.dataset import VolumetricDataset


def voxel_centers(res: int, device="cuda") -> torch.Tensor:
    """(res³, 4) float32 homogeneous voxel centres i/(res − 1) − 0.5, in
    [z][y][x]-major order (x varies fastest), built on `device`: fp64 then
    rounded once, the JAX tool's numpy values bit for bit."""
    coords = torch.arange(res, dtype=torch.float64, device=device) / (res - 1) - 0.5
    gz, gy, gx = torch.meshgrid(coords, coords, coords, indexing="ij")
    return torch.stack([gx, gy, gz, torch.ones_like(gx)], dim=-1).reshape(-1, 4).float()


def _project(projections: torch.Tensor, vox: torch.Tensor) -> torch.Tensor:
    """(C, 4, 4) world→pixel · (V, 4) voxels → (C, V, 3) fp32, rounded as the
    JAX tool's `einsum` is on XLA's CPU backend: per row the pairs (x, z) and
    (y, w), each fl(p·x) then a fused multiply-add of the other, and their
    fp32 sum. The products are exact in fp64, so the fused adds are fp64 adds
    rounded once to fp32 (twice only when the fp64 sum itself rounds, a rare
    tie that can move one result by one ulp); every op is a separate torch
    op, so no device contracts them differently."""
    p = projections[:, :3, :, None].double()  # (C, 3, 4, 1)
    x, y, z, w = vox.T.double()

    def fused_pair(a: int, b: int, va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
        first = (p[:, :, a] * va).float().double()
        return (p[:, :, b] * vb + first).float()

    return (fused_pair(0, 2, x, z) + fused_pair(1, 3, y, w)).transpose(1, 2)


def _carve(masks, projections, widths, heights, threshold, grid_resolution, device="cuda", chunk=262144):
    """masks: (C, maxW·maxH) uint8, each camera's dilated mask row-major at
    its own width; projections: (C, 4, 4) world→pixel; widths, heights: (C,).
    → (res³,) uint8 grid, 255 where at least `threshold` cameras see the
    voxel, in [z][y][x]-major order. Runs on `device`."""
    device = torch.device(device)
    masks_t = torch.as_tensor(masks, device=device)
    projections_t = torch.as_tensor(np.asarray(projections, dtype=np.float32), device=device)
    widths_t = torch.as_tensor(np.asarray(widths), device=device).long()[:, None]
    heights_t = torch.as_tensor(np.asarray(heights), device=device).long()[:, None]
    voxels = voxel_centers(grid_resolution, device)

    out = torch.empty(voxels.shape[0], dtype=torch.uint8, device=device)
    for start in range(0, voxels.shape[0], chunk):
        proj = _project(projections_t, voxels[start : start + chunk])
        z = proj[..., 2]
        fx, fy = torch.floor(proj[..., 0] / z).long(), torch.floor(proj[..., 1] / z).long()
        covered = torch.zeros(z.shape, dtype=torch.bool, device=device)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            x, y = fx + dx, fy + dy
            in_bounds = (x >= 0) & (x < widths_t) & (y >= 0) & (y < heights_t)
            flat = torch.clamp(y * widths_t + x, 0, masks_t.shape[1] - 1)
            covered |= in_bounds & (torch.gather(masks_t, 1, flat) > 0)
        count = (covered & (z > 0)).sum(dim=0)
        out[start : start + chunk] = (count >= threshold).to(torch.uint8) * 255
    return out.cpu().numpy()


class CarveInputs(NamedTuple):
    """What every frame's carve shares: the cameras with images, the frames
    they have, their (C, 4, 4) world→pixel matrices in the normalized cube,
    their sizes, the mask dilation and the masks' row stride."""

    camera_numbers: List[int]
    frame_numbers: List[int]
    projections: np.ndarray
    widths: np.ndarray
    heights: np.ndarray
    dilation_size: int
    side: int


def carve_inputs(dataset: VolumetricDataset) -> CarveInputs:
    """The scene is assumed to lie in [-0.5, 0.5]³ after the loader's
    normalization."""
    scene_offset, scene_scale = dataset.get_scene_normalization()
    cameras = dataset.get_scaled_cameras(scene_offset=scene_offset, scene_scale=scene_scale)
    camera_numbers, frame_numbers = dataset.get_available_cameras_and_frames()
    available = [cameras[i] for i in camera_numbers]
    side = max(max(c.width, c.height) for c in available)
    return CarveInputs(
        camera_numbers=camera_numbers,
        frame_numbers=frame_numbers,
        projections=np.stack([cam.projection_matrix_world2pixel() for cam in available]).astype(np.float32),
        widths=np.asarray([cam.width for cam in available], dtype=np.int32),
        heights=np.asarray([cam.height for cam in available], dtype=np.int32),
        dilation_size=max(side // 128, 1),  # a margin so that ray marching cannot cross the surface
        side=side,
    )


def dilated_masks(dataset: VolumetricDataset, inputs: CarveInputs, frame_number: int) -> np.ndarray:
    """(C, side²) uint8: each camera's mask at `frame_number`, dilated by a
    square of side `inputs.dilation_size`, row-major at its own width."""
    masks = np.zeros((len(inputs.camera_numbers), inputs.side * inputs.side), dtype=np.uint8)

    def load(buffer_index, camera_number):
        mask = dataset.get_mask(camera_number, frame_number, normalize=False)
        mask = morphology.dilate(mask, inputs.dilation_size)
        masks[buffer_index, : mask.size] = mask.reshape(-1)

    with ThreadPool(min(multiprocessing.cpu_count(), len(inputs.camera_numbers))) as pool:
        pool.starmap(load, enumerate(inputs.camera_numbers))
    return masks


def carve_frame(dataset: VolumetricDataset, inputs: CarveInputs, frame_number: int, threshold: int,
                grid_resolution: int, device="cuda") -> np.ndarray:
    """One frame's (res, res, res) uint8 [z][y][x] grid, carved on `device`."""
    masks = dilated_masks(dataset, inputs, frame_number)
    grid = _carve(masks, inputs.projections, inputs.widths, inputs.heights, threshold, grid_resolution, device)
    return grid.reshape((grid_resolution,) * 3)


def generate_occupancy_grid_from_masks(
    data_folder: Path, grid_resolution: int, camera_coverage_threshold: int, device="cuda"
) -> None:
    """Carve the grid of every available frame into
    `<sequence>/occupancy_grids/occupancy_grid%06d.npz` (key
    `occupancy_grid`, (res, res, res) uint8 [z][y][x])."""
    dataset = VolumetricDataset(data_folder)
    inputs = carve_inputs(dataset)
    print(f"Generating occupancy grids for {data_folder} at resolution {grid_resolution}")
    for frame_number in inputs.frame_numbers:
        grid = carve_frame(dataset, inputs, frame_number, camera_coverage_threshold, grid_resolution, device)
        output_path = dataset.filepaths.get_occupancy_grid_path(frame_number)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(str(output_path), occupancy_grid=grid)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_folder", type=Path, required=True)
    parser.add_argument("--grid_resolution", type=int, required=True)
    parser.add_argument("--camera_coverage_threshold", type=int, required=True)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    generate_occupancy_grid_from_masks(args.data_folder, args.grid_resolution, args.camera_coverage_threshold,
                                       args.device)


if __name__ == "__main__":
    main()
