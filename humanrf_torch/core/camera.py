"""Camera model for the ActorsHQ on-disk schema.

Counterpart of `humanrf_tpu/core/camera.py` (numpy and scipy only; that
package's `core/__init__.py` imports OpenCV, so it is not imported from):
right-down-forward (RDF / COLMAP) convention, right-handed, column vectors,
extrinsics stored as axis-angle cam2world, intrinsics stored *normalized* by
image width/height. The calibration CSV columns are
``name,w,h,rx,ry,rz,tx,ty,tz,fx,fy,px,py``.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np
from scipy.spatial.transform import Rotation


@dataclass
class CameraData:
    name: str
    width: int
    height: int

    # Extrinsics: cam2world, i.e. world = R @ cam + t.
    rotation_axisangle: np.ndarray = field(default_factory=lambda: np.zeros(3))
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))

    # Intrinsics, normalized by width/height.
    focal_length: np.ndarray = field(default_factory=lambda: np.ones(2))
    principal_point: np.ndarray = field(default_factory=lambda: 0.5 * np.ones(2))

    # Optional distortion coefficients (stored but unused by the renderer,
    # matching the reference).
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0

    @property
    def fx_pixel(self) -> float:
        return self.width * self.focal_length[0]

    @property
    def fy_pixel(self) -> float:
        return self.height * self.focal_length[1]

    @property
    def cx_pixel(self) -> float:
        return self.width * self.principal_point[0]

    @property
    def cy_pixel(self) -> float:
        return self.height * self.principal_point[1]

    def intrinsic_matrix(self) -> np.ndarray:
        return np.array(
            [
                [self.fx_pixel, 0.0, self.cx_pixel],
                [0.0, self.fy_pixel, self.cy_pixel],
                [0.0, 0.0, 1.0],
            ]
        )

    def rotation_matrix_cam2world(self) -> np.ndarray:
        return Rotation.from_rotvec(self.rotation_axisangle).as_matrix()

    def extrinsic_matrix_cam2world(self) -> np.ndarray:
        tfm = np.eye(4)
        tfm[:3, :3] = self.rotation_matrix_cam2world()
        tfm[:3, 3] = self.translation
        return tfm

    def projection_matrix_world2pixel(self) -> np.ndarray:
        """4x4 world→pixel projection (divide by z as the final step)."""
        tfm = np.eye(4)
        tfm[:3] = self.intrinsic_matrix() @ np.linalg.inv(self.extrinsic_matrix_cam2world())[:3]
        return tfm

    def inverse_kr(self) -> np.ndarray:
        """3x3 matrix mapping homogeneous pixel coords (x+0.5, y+0.5, 1) to an
        (unnormalized) world-space ray direction: ``dir = inv(P)[:3,:3] @ pix``.

        This is the row-major equivalent of the reference's column-major glm
        matrix upload (`data_loader.py:194-207`).
        """
        return np.linalg.inv(self.projection_matrix_world2pixel())[:3, :3]


def write_calibration_csv(cameras: List[CameraData], output_csv_path: Path) -> None:
    names = ["name", "w", "h", "rx", "ry", "rz", "tx", "ty", "tz", "fx", "fy", "px", "py"]
    with open(output_csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=names)
        writer.writeheader()
        for cam in cameras:
            writer.writerow(
                {
                    "name": cam.name,
                    "w": cam.width,
                    "h": cam.height,
                    "rx": cam.rotation_axisangle[0],
                    "ry": cam.rotation_axisangle[1],
                    "rz": cam.rotation_axisangle[2],
                    "tx": cam.translation[0],
                    "ty": cam.translation[1],
                    "tz": cam.translation[2],
                    "fx": cam.focal_length[0],
                    "fy": cam.focal_length[1],
                    "px": cam.principal_point[0],
                    "py": cam.principal_point[1],
                }
            )


def read_calibration_csv(input_csv_path: Path) -> List[CameraData]:
    cameras = []
    with open(input_csv_path, "r", newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            cameras.append(
                CameraData(
                    name=row["name"],
                    width=int(row["w"]),
                    height=int(row["h"]),
                    rotation_axisangle=np.array([float(row["rx"]), float(row["ry"]), float(row["rz"])]),
                    translation=np.array([float(row["tx"]), float(row["ty"]), float(row["tz"])]),
                    focal_length=np.array([float(row["fx"]), float(row["fy"])]),
                    principal_point=np.array([float(row["px"]), float(row["py"])]),
                )
            )
    return cameras
