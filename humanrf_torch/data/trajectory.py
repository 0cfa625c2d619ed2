"""Novel-view trajectory data loaders.

Counterpart of `humanrf_tpu/data/trajectory.py` over the port's `DataLoader`:

- `generate_camera_trajectory`: a smooth path through key cameras, the
  world-to-camera rotations slerped and the world-to-camera translations
  interpolated by a spline of degree min(2, K − 1), at times spaced by the
  distance between the key cameras' positions;
- `_ping_pong_sequence`: the (camera, frame) zipper that walks cameras and
  frames back and forth together;
- `get_trajectory_dataloader_from_calibration`: copies a calibration file
  into `<sequence>/test/` beside the data folder, **deleting that folder
  first when it exists**, and builds a TEST loader over it;
- `get_trajectory_dataloader_from_keycams`: one key camera renders every
  frame from that camera; two or more make a trajectory, written to a
  temporary calibration file and loaded as above.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from tempfile import TemporaryDirectory
from typing import List, Tuple

import numpy as np
from scipy import interpolate
from scipy.spatial.transform import Rotation, Slerp

from humanrf_torch.core.camera import CameraData, read_calibration_csv, write_calibration_csv
from humanrf_torch.core.dataset import VolumetricDataset, VolumetricDatasetFilepaths
from humanrf_torch.data.loader import DataLoader


def generate_camera_trajectory(
    key_cameras: List[CameraData],
    intrinsics_camera: CameraData,
    num_frames: int,
) -> List[CameraData]:
    """`num_frames` cameras through `key_cameras` at times linspace(1e-5,
    1 − 1e-5), each with the intrinsics of `intrinsics_camera`."""
    key_rotations_w2c = np.stack([cam.rotation_matrix_cam2world().T for cam in key_cameras], axis=0)
    key_translations_w2c = np.stack(
        [-rot @ cam.translation for cam, rot in zip(key_cameras, key_rotations_w2c)], axis=0
    )
    key_positions = np.stack([cam.translation for cam in key_cameras], axis=0)

    interval_lengths = np.linalg.norm(key_positions[1:] - key_positions[:-1], axis=1)
    interval_lengths = interval_lengths / interval_lengths.sum()
    key_times = np.cumsum([0] + list(interval_lengths))

    slerp = Slerp(key_times, Rotation.from_matrix(key_rotations_w2c))
    spline = interpolate.make_interp_spline(key_times, key_translations_w2c, k=min(2, len(key_cameras) - 1))

    times = np.linspace(1e-5, 1 - 1e-5, num_frames)
    rotations = slerp(times).as_matrix().astype(np.float32)
    translations = spline(times).astype(np.float32)

    num_decimals = int(np.log10(num_frames)) + 1
    return [
        CameraData(
            name=f"Cam{idx + 1}".zfill(num_decimals),
            width=intrinsics_camera.width,
            height=intrinsics_camera.height,
            rotation_axisangle=Rotation.from_matrix(rot_w2c.T).as_rotvec(),
            translation=-rot_w2c.T @ t_w2c,
            focal_length=intrinsics_camera.focal_length.copy(),
            principal_point=intrinsics_camera.principal_point.copy(),
        )
        for idx, (rot_w2c, t_w2c) in enumerate(zip(rotations, translations))
    ]


def _ping_pong_sequence(num_cameras: int, frame_numbers: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """max(#cameras, #frames) (camera, frame) pairs; each index runs forward,
    then backward, repeating the endpoint where it turns."""
    render_sequence = []
    total_num_frames = len(frame_numbers)
    for num in range(max(total_num_frames, num_cameras)):
        camera_number = num % num_cameras
        if (num // num_cameras) % 2 == 1:
            camera_number = num_cameras - 1 - camera_number
        frame_idx = num % total_num_frames
        if (num // total_num_frames) % 2 == 1:
            frame_idx = total_num_frames - 1 - frame_idx
        render_sequence.append((camera_number, frame_numbers[frame_idx]))
    return render_sequence


def get_trajectory_dataloader_from_calibration(
    calibration_path: Path,
    base_data_folder: Path,
    space_pruning_mode: DataLoader.SpacePruningMode,
    batch_size: int,
    frame_numbers: Tuple[int, ...],
    device=None,
) -> DataLoader:
    """A TEST loader over the cameras of `calibration_path`, copied into
    `<sequence>/test/` (re-created), ping-ponging cameras against frames."""
    test_data_folder = Path(base_data_folder).parent / "test"
    if test_data_folder.exists():
        shutil.rmtree(test_data_folder)
    test_data_folder.mkdir()
    new_fp = VolumetricDatasetFilepaths(test_data_folder)
    shutil.copy(calibration_path, new_fp.calibration_path)

    new_cameras = read_calibration_csv(new_fp.calibration_path)
    if not new_cameras:
        raise ValueError(f"{calibration_path} holds no camera")
    return DataLoader(
        dataset=VolumetricDataset(new_fp.folder, crop_center_square=False),
        mode=DataLoader.Mode.TEST,
        space_pruning_mode=space_pruning_mode,
        batch_size=batch_size,
        camera_numbers=tuple(range(len(new_cameras))),
        frame_numbers=tuple(frame_numbers),
        max_buffer_size=1,
        render_sequence=_ping_pong_sequence(len(new_cameras), tuple(frame_numbers)),
        device=device,
    )


def get_trajectory_dataloader_from_keycams(
    trajectory: Tuple[int, ...],
    base_data_folder: Path,
    space_pruning_mode: DataLoader.SpacePruningMode,
    batch_size: int,
    frame_numbers: Tuple[int, ...],
    trajectory_num_cameras: int,
    device=None,
) -> DataLoader:
    """A TEST loader along the trajectory through the dataset's cameras
    `trajectory` (`trajectory_num_cameras` cameras, the intrinsics of the
    second key camera), or, for one key camera, that camera at every frame."""
    base_data_folder = Path(base_data_folder)
    if len(trajectory) == 1:
        return DataLoader(
            dataset=VolumetricDataset(base_data_folder, crop_center_square=False),
            mode=DataLoader.Mode.TEST,
            space_pruning_mode=space_pruning_mode,
            batch_size=batch_size,
            camera_numbers=tuple(trajectory),
            frame_numbers=tuple(frame_numbers),
            max_buffer_size=1,
            render_sequence=[(trajectory[0], fn) for fn in frame_numbers],
            device=device,
        )

    cameras = read_calibration_csv(VolumetricDatasetFilepaths(base_data_folder).calibration_path)
    trajectory_cameras = generate_camera_trajectory(
        key_cameras=[cameras[i] for i in trajectory],
        intrinsics_camera=cameras[trajectory[1]],
        num_frames=trajectory_num_cameras,
    )
    with TemporaryDirectory() as tmpdir:
        tmp_calibration = Path(tmpdir) / "calibration.csv"
        write_calibration_csv(trajectory_cameras, tmp_calibration)
        return get_trajectory_dataloader_from_calibration(
            calibration_path=tmp_calibration,
            base_data_folder=base_data_folder,
            space_pruning_mode=space_pruning_mode,
            batch_size=batch_size,
            frame_numbers=tuple(frame_numbers),
            device=device,
        )
