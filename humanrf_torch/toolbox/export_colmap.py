#!/usr/bin/env python3
"""COLMAP text-model exporter: calibration.csv → a sparse-model directory.

The port's copy of `humanrf_tpu/toolbox/export_colmap.py` (numpy and scipy;
the same files, held equal by `tests/test_torch_toolbox.py`), written
against the COLMAP sparse text-model format
(https://colmap.github.io/format.html):

- ``cameras.txt``  — one line per camera: ``CAMERA_ID MODEL W H PARAMS...``
  with the PINHOLE model (params fx fy cx cy, in pixels).
- ``images.txt``   — two lines per image: ``IMAGE_ID QW QX QY QZ TX TY TZ
  CAMERA_ID NAME`` (world→camera rotation as a Hamilton quaternion, then
  ``t = −R·C``), followed by the (empty) 2D-point observations line.
- ``points3D.txt`` — no reconstructed points.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Iterable, List, Tuple

import numpy as np

from humanrf_torch.core.camera import CameraData, read_calibration_csv


def _world_to_camera(camera: CameraData) -> Tuple[np.ndarray, np.ndarray]:
    """COLMAP stores extrinsics as world→camera: (quaternion wxyz, tvec)."""
    from scipy.spatial.transform import Rotation

    r_w2c = camera.rotation_matrix_cam2world().T
    qx, qy, qz, qw = Rotation.from_matrix(r_w2c).as_quat()
    return np.array([qw, qx, qy, qz]), -r_w2c @ camera.translation


def _camera_record(camera_id: int, camera: CameraData) -> str:
    params = (camera.fx_pixel, camera.fy_pixel, camera.cx_pixel, camera.cy_pixel)
    fields = [camera_id, "PINHOLE", camera.width, camera.height, *params]
    return " ".join(str(v) for v in fields)


def _image_record(image_id: int, camera_id: int, camera: CameraData) -> str:
    quat, tvec = _world_to_camera(camera)
    fields = [image_id, *quat, *tvec, camera_id, camera.name]
    # Second line lists 2D keypoint observations — none in a synthetic export.
    return " ".join(str(v) for v in fields) + "\n"


def export_as_colmap(cameras: Iterable[CameraData], output_folder: Path) -> None:
    output_folder = Path(output_folder)
    cameras = list(cameras)

    model_files = {
        "cameras.txt": (_camera_record(i, cam) for i, cam in enumerate(cameras)),
        "images.txt": (_image_record(i, i, cam) for i, cam in enumerate(cameras)),
        "points3D.txt": iter(["# Empty file..."]),
    }
    for filename, records in model_files.items():
        with open(output_folder / filename, "w") as f:
            for record in records:
                f.write(record + "\n")


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--csv", type=Path, required=True)
    parser.add_argument("--output_dir", type=Path, required=True)
    args = parser.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    export_as_colmap(read_calibration_csv(args.csv), args.output_dir)


if __name__ == "__main__":
    main()
