#!/usr/bin/env python3
"""Dynamic-Furry-Animals → ActorsHQ-format importer.

The port's copy of `humanrf_tpu/toolbox/import_dfa.py`, converting images
through `core/image_io` and carving on `--device` (the GPU by default) with
the port's `generate_occupancy_grids_from_masks`. The DFA release
(github.com/HaiminLuo/Artemis) ships:

- ``img/<motion>/<frame>/img_%04d.png`` + ``img_%04d_alpha.png`` — 36 views;
- ``Intrinsic.inf`` — per camera ``idx\\n fx 0 cx\\n 0 fy cy\\n 0 0 1\\n\\n``
  (pixels, 1920×1080);
- ``CamPose.inf`` — one row per camera: the cam→world [R|T] printed
  column-wise in the order (col3, col1, col2, T).

DFA has no AABBs or occupancy grids, so they are bootstrapped: assume the
±1.5 cube, visual-hull carve grids from the mattes, tighten per-frame AABBs
to the carved voxels, then carve final grids inside the tight boxes.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import List

import numpy as np
from scipy.spatial.transform import Rotation

from humanrf_torch.core import image_io
from humanrf_torch.core.aabb import AabbData, write_aabbs_csv
from humanrf_torch.core.camera import CameraData, write_calibration_csv
from humanrf_torch.core.dataset import VolumetricDataset, VolumetricDatasetFilepaths
from humanrf_torch.toolbox.generate_occupancy_grids_from_masks import generate_occupancy_grid_from_masks

NUM_DFA_CAMERAS = 36
DFA_WIDTH, DFA_HEIGHT = 1920, 1080
DFA_BOUND = 1.5  # DFA scenes are contained in the ±1.5 cube.
GRID_RESOLUTION = 256


def _convert_images(images_path: Path, out: VolumetricDatasetFilepaths) -> List[int]:
    """Copy every view's rgb (re-encoded) and matte into the per-camera layout."""
    frame_numbers = []
    for frame_dir in sorted(images_path.glob("*")):
        frame = int(frame_dir.stem)
        frame_numbers.append(frame)
        for cam_idx in range(NUM_DFA_CAMERAS):
            name = f"Cam{cam_idx:03d}"
            src_rgb = frame_dir / f"img_{cam_idx:04d}.png"
            src_alpha = frame_dir / f"img_{cam_idx:04d}_alpha.png"
            for src in (src_rgb, src_alpha):
                if not src.exists():
                    raise FileNotFoundError(f"DFA view image missing: {src}")
            dst_rgb = out.get_rgb_path(name, frame)
            dst_mask = out.get_mask_path(name, frame)
            dst_rgb.parent.mkdir(parents=True, exist_ok=True)
            dst_mask.parent.mkdir(parents=True, exist_ok=True)
            image_io.imwrite(dst_rgb, image_io.imread(src_rgb))  # png → dataset rgb format
            shutil.copy(src_alpha, dst_mask)
    return sorted(frame_numbers)


def _read_dfa_cameras(dfa_root: Path) -> List[CameraData]:
    # Intrinsic.inf: 5 lines per camera (idx, K rows ×3, blank).
    intrinsic_lines = (dfa_root / "Intrinsic.inf").read_text().splitlines()
    pose_lines = (dfa_root / "CamPose.inf").read_text().splitlines()

    cameras = []
    for cam_idx in range(NUM_DFA_CAMERAS):
        block = intrinsic_lines[cam_idx * 5 : cam_idx * 5 + 5]
        if int(block[0].strip()) != cam_idx:
            raise ValueError(f"Intrinsic.inf out of order at camera {cam_idx}")
        k_row0 = [float(v) for v in block[1].split()]
        k_row1 = [float(v) for v in block[2].split()]

        # CamPose.inf row: cam→world columns in the order (3rd, 1st, 2nd, T).
        vals = np.array([float(v) for v in pose_lines[cam_idx].split()])
        cam2world = np.column_stack([vals[3:6], vals[6:9], vals[0:3]])

        cameras.append(
            CameraData(
                name=f"Cam{cam_idx:03d}",
                width=DFA_WIDTH,
                height=DFA_HEIGHT,
                rotation_axisangle=Rotation.from_matrix(cam2world).as_rotvec(),
                translation=vals[9:12],
                focal_length=np.array([k_row0[0] / DFA_WIDTH, k_row1[1] / DFA_HEIGHT]),
                principal_point=np.array([k_row0[2] / DFA_WIDTH, k_row1[2] / DFA_HEIGHT]),
            )
        )
    return cameras


def _tighten_aabbs(dataset: VolumetricDataset, frame_numbers: List[int]) -> List[AabbData]:
    """Shrink each frame's AABB to the carved grid's occupied voxels.

    Grids are stored [z][y][x]; world x varies along the innermost axis.
    """
    lin = np.linspace(-DFA_BOUND, DFA_BOUND, GRID_RESOLUTION)
    gz, gy, gx = np.meshgrid(lin, lin, lin, indexing="ij")
    world = np.stack((gx, gy, gz), axis=-1)

    tightened = []
    for frame in frame_numbers:
        occupied = world[dataset.get_occupancy_grid(frame) > 0]
        box = np.stack((occupied.min(axis=0), occupied.max(axis=0)))
        if not (np.abs(box) < DFA_BOUND).all():
            raise ValueError(f"frame {frame}: carved content touches the ±{DFA_BOUND} bound")
        tightened.append(AabbData(frame_number=frame, aabb=box))
    return tightened


def import_dfa(dfa_dataset_folder: Path, motion_type: str, output_folder: Path, device="cuda") -> None:
    dfa_root = Path(dfa_dataset_folder)
    output_folder = Path(output_folder)
    out = VolumetricDatasetFilepaths(output_folder)

    frame_numbers = _convert_images(dfa_root / "img" / motion_type, out)
    write_calibration_csv(_read_dfa_cameras(dfa_root), out.calibration_path)
    print("Calibration file is written.")

    def carve():
        generate_occupancy_grid_from_masks(
            data_folder=output_folder,
            grid_resolution=GRID_RESOLUTION,
            camera_coverage_threshold=NUM_DFA_CAMERAS,
            device=device,
        )

    # Bootstrap: loose cube → carve → tighten → carve again inside tight boxes.
    loose = np.array([[-DFA_BOUND] * 3, [DFA_BOUND] * 3])
    write_aabbs_csv([AabbData(f, loose) for f in frame_numbers], out.aabbs_path)
    print("Initial aabbs.csv is written.")
    carve()
    print("Initial occupancy grids are generated.")

    write_aabbs_csv(_tighten_aabbs(VolumetricDataset(output_folder), frame_numbers), out.aabbs_path)
    print("Final aabbs.csv is written.")
    carve()
    print("Final occupancy grids are generated.")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dfa_dataset_folder", type=Path, required=True)
    parser.add_argument("--motion_type", type=str, required=True)
    parser.add_argument("--output_folder", type=Path, required=True)
    parser.add_argument("--device", default="cuda", help="where to carve: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    import_dfa(args.dfa_dataset_folder, args.motion_type, args.output_folder, args.device)


if __name__ == "__main__":
    main()
