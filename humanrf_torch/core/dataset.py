"""ActorsHQ on-disk dataset model.

Counterpart of `humanrf_tpu/core/dataset.py`, reading images through the
port's codec (`core/image_io.py`) instead of OpenCV, with the same results:

    <actor>/<sequence>/<scale>x/calibration.csv
    <actor>/<sequence>/<scale>x/rgbs/<cam>/<cam>_rgb%06d.jpg
    <actor>/<sequence>/<scale>x/masks/<cam>/<cam>_mask%06d.png
    <actor>/<sequence>/<scale>x/light_annotations.csv
    <actor>/<sequence>/aabbs.csv
    <actor>/<sequence>/occupancy_grids/occupancy_grid%06d.npz
    <actor>/<sequence>/scene.json
"""
from __future__ import annotations

import copy
import csv
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from humanrf_torch.core import image_io
from humanrf_torch.core.aabb import read_aabbs_csv
from humanrf_torch.core.camera import CameraData, read_calibration_csv


class VolumetricDatasetFilepaths:
    """Path resolution for the ActorsHQ layout: every artifact is a row
    (anchor, relative template). Anchor "scale" is the `<actor>/<sequence>/
    <scale>x` folder; anchor "sequence" its parent. `{frame}` renders as a
    zero-padded frame number, or as a printf pattern when it is "%06d"."""

    LAYOUT = {
        "calibration": ("scale", "calibration.csv"),
        "light_annotations": ("scale", "light_annotations.csv"),
        "rgb": ("scale", "rgbs/{camera}/{camera}_rgb{frame}.jpg"),
        "mask": ("scale", "masks/{camera}/{camera}_mask{frame}.png"),
        "aabbs": ("sequence", "aabbs.csv"),
        "metadata": ("sequence", "scene.json"),
        "occupancy_grid": ("sequence", "occupancy_grids/occupancy_grid{frame}.npz"),
    }

    def __init__(self, data_folder: Path) -> None:
        self.folder = Path(data_folder)

    def path(self, kind: str, camera: Optional[str] = None, frame=None) -> Path:
        anchor, template = self.LAYOUT[kind]
        root = self.folder if anchor == "scale" else self.folder.parent
        frame_str = f"{frame:06d}" if isinstance(frame, int) else frame
        return root / template.format(camera=camera, frame=frame_str)

    @property
    def calibration_path(self) -> Path:
        return self.path("calibration")

    @property
    def aabbs_path(self) -> Path:
        return self.path("aabbs")

    @property
    def metadata_path(self) -> Path:
        return self.path("metadata")

    def get_rgb_path(self, camera_name: str, frame_number: int) -> Path:
        return self.path("rgb", camera=camera_name, frame=frame_number)

    def get_mask_path(self, camera_name: str, frame_number: int) -> Path:
        return self.path("mask", camera=camera_name, frame=frame_number)

    def get_occupancy_grid_path(self, frame_number: int) -> Path:
        return self.path("occupancy_grid", frame=frame_number)

    def get_light_annotations_path(self) -> Path:
        return self.path("light_annotations")


class VolumetricDataset:
    def __init__(self, data_folder: Path, crop_center_square: bool = False) -> None:
        self.filepaths = VolumetricDatasetFilepaths(data_folder=data_folder)
        self.cameras = read_calibration_csv(self.filepaths.calibration_path)
        self.aabbs = read_aabbs_csv(self.filepaths.aabbs_path)
        self.crop_offsets = self._crop_cameras() if crop_center_square else None
        self._cname2cnum = {c.name: i for i, c in enumerate(self.cameras)}
        self._fnum2aabb = {a.frame_number: a for a in self.aabbs}

    def get_available_cameras_and_frames(self) -> Tuple[List[int], List[int]]:
        """Cameras with a non-empty rgb folder, and the frames of aabbs.csv
        whose rgb image the first of them has."""
        cameras = [
            cn for cn, cam in enumerate(self.cameras)
            if any(self.filepaths.get_rgb_path(cam.name, 0).parent.glob("*"))
        ]
        frames = [fn for fn in self._fnum2aabb if self.filepaths.get_rgb_path(self.cameras[cameras[0]].name, fn).exists()]
        return cameras, frames

    def get_scaled_cameras(self, scene_offset: np.ndarray, scene_scale: float) -> List[CameraData]:
        """Translate + scale camera positions into the canonical cube frame."""
        cameras = copy.deepcopy(self.cameras)
        for cam in cameras:
            cam.translation = (cam.translation + scene_offset) * scene_scale
        return cameras

    def get_aabb(self, frame_numbers: Optional[List[int]] = None) -> np.ndarray:
        """Union AABB over the given frames (or all frames)."""
        aabbs = self.aabbs if frame_numbers is None else [self._fnum2aabb[i] for i in frame_numbers]
        all_aabbs = np.stack([a.aabb for a in aabbs], axis=0)
        return np.stack((all_aabbs[:, 0].min(0), all_aabbs[:, 1].max(0)), axis=0)

    def get_scene_normalization(self) -> Tuple[np.ndarray, float]:
        """(scene_offset, scene_scale) that map the union AABB into [-0.5, 0.5]
        on its longest axis, as the loader normalizes the scene."""
        aabb = self.get_aabb()
        return -aabb.mean(0), float(1.0 / np.max(aabb[1] - aabb[0]))

    def get_occupancy_grid(self, frame_number: int) -> np.ndarray:
        return np.load(self.filepaths.get_occupancy_grid_path(frame_number))["occupancy_grid"]

    def _crop(self, camera_number: int, image: np.ndarray) -> np.ndarray:
        crop_x, crop_y = self.crop_offsets[camera_number] if self.crop_offsets is not None else (0, 0)
        camera = self.cameras[camera_number]
        return image[crop_y : crop_y + camera.height, crop_x : crop_x + camera.width]

    def get_rgb(self, camera_number: int, frame_number: int) -> np.ndarray:
        """BGR image (cv2 channel order, as the JAX package reads it), float32
        in [0, 1]."""
        rgb = image_io.imread(self.filepaths.get_rgb_path(self.cameras[camera_number].name, frame_number))
        return self._crop(camera_number, rgb / np.float32(255))

    def get_mask(self, camera_number: int, frame_number: int, normalize: bool = True) -> np.ndarray:
        """(H, W, 1): the mask image's first channel, float32 in [0, 1]
        (uint8 without `normalize`)."""
        mask = image_io.imread(self.filepaths.get_mask_path(self.cameras[camera_number].name, frame_number))[..., 0:1]
        return self._crop(camera_number, mask / np.float32(255) if normalize else mask)

    def get_light_annotations(self) -> Dict[int, List[Tuple[int, int, int]]]:
        with open(self.filepaths.get_light_annotations_path()) as f:
            annotations = defaultdict(list)
            for row in csv.DictReader(f):
                camera_number = self._cname2cnum[row["camera"]]
                crop_x, crop_y = self.crop_offsets[camera_number] if self.crop_offsets is not None else (0, 0)
                annotations[camera_number].append(
                    (round(float(row["x"]) - crop_x), round(float(row["y"]) - crop_y), round(float(row["r"])))
                )
            return annotations

    def _crop_cameras(self) -> List[Tuple[int, int]]:
        """Adjust cameras to the center-square crop, intrinsics rescaled;
        returns the top-left crop offsets."""
        crop_offsets = []
        for camera in self.cameras:
            offset = np.abs(camera.height - camera.width) // 2
            if camera.width < camera.height:
                offset_h, offset_w = offset, 0
                new_width = new_height = camera.width
            else:
                offset_h, offset_w = 0, offset
                new_width = new_height = camera.height

            crop_offsets.append((offset_w, offset_h))
            camera.principal_point[0] -= offset_w / camera.width
            camera.principal_point[1] -= offset_h / camera.height

            scaling_w = camera.width / new_width
            scaling_h = camera.height / new_height
            camera.focal_length[0] *= scaling_w
            camera.focal_length[1] *= scaling_h
            camera.principal_point[0] *= scaling_w
            camera.principal_point[1] *= scaling_h

            camera.width = new_width
            camera.height = new_height
        return crop_offsets
