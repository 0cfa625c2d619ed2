#!/usr/bin/env python3
"""Instant-NGP dataset exporter: one frame → per-camera ``transformsNNN.json``
plus background-masked RGBA images.

The port's copy of `humanrf_tpu/toolbox/export_ngp.py`, writing its images
through `core/image_io` (the same files, held equal by
`tests/test_torch_toolbox.py`), against the instant-ngp NeRF dataset format
(nerf_loader / colmap2nerf conventions):

- NGP's world frame permutes ours: NGP (x, y, z) = ours (z, x, y).
- NGP cameras look down −z with y up, i.e. our camera frame with y and z
  negated.
- NGP multiplies loaded scenes by 1/3 around ``offset``, so the scene is
  pre-scaled by 0.95·3/extent and re-centered to fill NGP's unit box.
- Intrinsics are given both as pixel focal lengths (fl_x/fl_y) and as full
  field-of-view angles; distortion coefficients are zero (ActorsHQ images
  are undistorted).
"""
from __future__ import annotations

import argparse
import json
import math
import os
from pathlib import Path
from typing import List

import numpy as np

from humanrf_torch.core import image_io
from humanrf_torch.core.camera import CameraData
from humanrf_torch.core.dataset import VolumetricDataset

# Change of basis: our world axis k becomes NGP world axis _WORLD_PERM[k].
_OURS_TO_NGP_WORLD = np.array(
    [
        [0.0, 0.0, 1.0],
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
    ]
)
# Our RDF camera → NGP's RUB camera: flip y (down→up) and z (forward→back).
_RDF_TO_RUB = np.diag([1.0, -1.0, -1.0])


def _ngp_cam2world(camera: CameraData, scene_offset: np.ndarray, scene_scale: float) -> np.ndarray:
    pose = np.eye(4)
    pose[:3, :3] = _OURS_TO_NGP_WORLD @ camera.rotation_matrix_cam2world() @ _RDF_TO_RUB
    pose[:3, 3] = _OURS_TO_NGP_WORLD @ ((camera.translation + scene_offset) * scene_scale)
    return pose


def _ngp_intrinsics(camera: CameraData) -> dict:
    full_fov = lambda extent, focal: 2.0 * math.atan2(0.5 * extent, focal)
    return {
        "cx": camera.cx_pixel,
        "cy": camera.cy_pixel,
        "w": camera.width,
        "h": camera.height,
        "fl_x": camera.fx_pixel,
        "fl_y": camera.fy_pixel,
        "camera_angle_x": full_fov(camera.width, camera.fx_pixel),
        "camera_angle_y": full_fov(camera.height, camera.fy_pixel),
        # Undistorted input: zero radial/tangential coefficients.
        "k1": 0.0,
        "k2": 0.0,
        "p1": 0.0,
        "p2": 0.0,
    }


def export_as_ngp(
    cameras: List[CameraData],
    output_folder: Path,
    image_folder: Path,
    scene_offset: np.ndarray,
    scene_scale: float,
) -> None:
    """One transformsNNN.json per camera, each referencing its single image."""
    output_folder = Path(output_folder)
    images = sorted(Path(image_folder).glob("*"))
    for idx, (camera, image_path) in enumerate(zip(cameras, images)):
        pose = _ngp_cam2world(camera, scene_offset, scene_scale)
        doc = {
            **_ngp_intrinsics(camera),
            "aabb_scale": 1,
            "frames": [
                {
                    "file_path": os.path.relpath(image_path, output_folder),
                    "camera_name": camera.name,
                    "transform_matrix": pose.tolist(),
                }
            ],
        }
        with open(output_folder / f"transforms{idx:03d}.json", "w", encoding="UTF-8") as f:
            json.dump(doc, f, indent=2)


def to_u8(img: np.ndarray) -> np.ndarray:
    """A float image as `cv2.imwrite` stores it: each value rounded to the
    nearest integer, halves to even, and saturated to [0, 255]."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _write_masked_images(dataset: VolumetricDataset, camera_numbers, frame_number: int, image_folder: Path) -> None:
    """BGRA pngs with the background zeroed out (alpha = mask)."""
    image_folder.mkdir(parents=True, exist_ok=True)
    for number in camera_numbers:
        rgb = dataset.get_rgb(number, frame_number)
        alpha = dataset.get_mask(number, frame_number)
        rgba = np.dstack([rgb * alpha, alpha])
        out = image_folder / f"{dataset.cameras[number].name}.png"
        image_io.imwrite(out, to_u8(rgba * 255))


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_folder", type=Path, required=True)
    parser.add_argument("--frame_number", type=int, required=True)
    parser.add_argument("--output_dir", type=Path, required=True)
    args = parser.parse_args(argv)

    dataset = VolumetricDataset(args.data_folder)
    camera_numbers, frame_numbers = dataset.get_available_cameras_and_frames()
    if args.frame_number not in frame_numbers:
        raise RuntimeError("Requested frame number does not exist in the dataset!")

    # NGP rescales loaded scenes by 1/3 — pre-scale so the actor fills ~95%
    # of NGP's unit box, centered on the frame's AABB.
    aabb = dataset.get_aabb([args.frame_number])
    extent = float(np.max(aabb[1] - aabb[0]))

    image_folder = args.output_dir / "images"
    _write_masked_images(dataset, camera_numbers, args.frame_number, image_folder)
    export_as_ngp(
        cameras=[dataset.cameras[n] for n in camera_numbers],
        output_folder=args.output_dir,
        image_folder=image_folder,
        scene_offset=-aabb.mean(axis=0),
        scene_scale=0.95 * 3.0 / extent,
    )


if __name__ == "__main__":
    main()
