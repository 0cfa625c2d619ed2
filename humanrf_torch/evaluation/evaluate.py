"""Offline evaluation over a rendered result sequence.

Counterpart of `humanrf_tpu/evaluation/evaluate.py`: for each (camera, frame)
pair of the coverage, load the ground truth and the prediction, crop both to
the mask's bounding rectangle, compute masked PSNR, unmasked-ROI PSNR, SSIM
and (with pretrained weights only) LPIPS, optionally VMAF on the hero
camera's frames through ffmpeg and the `vmaf` CLI, and write `metrics.csv` and
`averages.csv`. Images are read through the port's codec.
"""
from __future__ import annotations

import csv
import os
import shutil
import subprocess
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import numpy as np

import humanrf_torch.evaluation.presets as presets
from humanrf_torch.core import image_io
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.evaluation.metrics import LpipsModel, bounding_rect, compute_psnr, compute_ssim


def _load_image_rgb(path: Path) -> np.ndarray:
    return image_io.imread(path)[..., ::-1].astype(np.float32) / 255.0  # BGR → RGB, [0, 1]


def _render_y4m(input_pattern: str, output: Path) -> None:
    subprocess.run(
        ["ffmpeg", "-y", "-i", input_pattern, "-pix_fmt", "yuv444p", "-loglevel", "error", str(output)],
        check=True,
        stdout=subprocess.DEVNULL,
    )


def evaluate(
    results_directory: Path,
    output_directory: Path,
    coverage: str,
    camera_preset: str,
    frame_numbers: List[int],
    data_folder: Path,
    result_suffix: str = ".png",
    camera_configs_override: Optional[dict] = None,
) -> dict:
    cameras_frames = presets.get_render_sequence(
        coverage, camera_preset, list(frame_numbers), camera_configs_override=camera_configs_override
    )
    dataset = VolumetricDataset(data_folder)
    lpips_model = LpipsModel.load_or_init()

    results = defaultdict(list)
    for camera_idx, frame_idx in cameras_frames:
        camera = dataset.cameras[camera_idx]
        gt_path = dataset.filepaths.get_rgb_path(camera.name, frame_idx)
        pred_path = Path(results_directory) / "test_frames" / (gt_path.stem + result_suffix)
        mask_np = image_io.imread(dataset.filepaths.get_mask_path(camera.name, frame_idx))[..., 0:1]
        gt = _load_image_rgb(gt_path)
        pred = _load_image_rgb(pred_path)

        x, y, w, h = bounding_rect(mask_np)
        gt_roi, pred_roi, mask_roi = gt[y : y + h, x : x + w], pred[y : y + h, x : x + w], mask_np[y : y + h, x : x + w]

        results["PSNR"].append(compute_psnr(pred_roi, gt_roi, mask=mask_roi))
        # Unmasked-ROI PSNR, the metric style of the trainer's validation.
        results["PSNR_ROI"].append(compute_psnr(pred_roi, gt_roi))
        if lpips_model.is_pretrained:
            results[lpips_model.metric_name.upper()].append(lpips_model(pred_roi, gt_roi))
        results["SSIM"].append(compute_ssim(pred_roi, gt_roi, data_range=1.0))

    averages = {}
    for metric, values in results.items():
        arr = np.asarray(values, dtype=np.float64)
        finite = arr[np.isfinite(arr)]
        if finite.size < arr.size:
            print(f"[WARNING] {arr.size - finite.size} non-finite {metric} value(s) excluded from average")
        averages[metric] = float(finite.mean()) if finite.size else float("nan")
    print(f"== Evaluating with {len(results['PSNR'])} frames ==")
    for metric, average in averages.items():
        print(f"{metric}: {average}")

    output_directory = Path(output_directory)
    output_directory.mkdir(exist_ok=True, parents=True)
    if coverage == "siggraph_test":
        _maybe_compute_vmaf(
            results_directory, output_directory, frame_numbers, data_folder, result_suffix,
            camera_configs_override=camera_configs_override,
        )
    with open(output_directory / "metrics.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["camera", "frame", *results.keys()])
        writer.writeheader()
        for i, (camera_idx, frame_idx) in enumerate(cameras_frames):
            writer.writerow({"camera": camera_idx + 1, "frame": frame_idx, **{k: results[k][i] for k in results}})
    with open(output_directory / "averages.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=averages.keys())
        writer.writeheader()
        writer.writerow(averages)
    return averages


def _maybe_compute_vmaf(
    results_directory, output_directory, frame_numbers, data_folder, result_suffix, camera_configs_override=None
):
    """VMAF on the hero camera's every-3rd-frame video; skipped when the
    frames, ffmpeg or the vmaf CLI are missing."""
    configs = camera_configs_override or presets.camera_configs
    if len(configs.get("siggraph_vmaf", ())) != 1:
        return
    cameras_frames_vmaf = [(configs["siggraph_vmaf"][0], f) for f in list(frame_numbers)[::3]]
    if not all(
        (Path(results_directory) / "test_frames" / f"Cam{c + 1:03d}_rgb{f:06d}{result_suffix}").exists()
        for c, f in cameras_frames_vmaf
    ):
        print("No frames for VMAF computation available, skipping VMAF.")
        return
    if shutil.which("ffmpeg") is None or shutil.which("vmaf") is None:
        print("ffmpeg/vmaf CLI not available, skipping VMAF.")
        return

    with tempfile.TemporaryDirectory() as tmpdir:
        path_gt, path_pred = Path(tmpdir) / "gt", Path(tmpdir) / "pred"
        path_gt.mkdir()
        path_pred.mkdir()
        for i, (c, f) in enumerate(cameras_frames_vmaf):
            cam_name = f"Cam{c + 1:03d}"
            src_gt = Path(data_folder) / "rgbs" / cam_name / f"{cam_name}_rgb{f:06d}.jpg"
            os.symlink(src_gt.resolve(), path_gt / f"{i:06d}.jpg")
            os.symlink(
                Path(results_directory).resolve() / "test_frames" / f"{cam_name}_rgb{f:06d}{result_suffix}",
                path_pred / f"{i:06d}{result_suffix}",
            )
        path_video_pred = Path(results_directory) / f"{cam_name}.y4m"
        path_video_gt = Path(tmpdir) / f"{cam_name}.y4m"
        _render_y4m(str(path_pred / f"%06d{result_suffix}"), path_video_pred)
        _render_y4m(str(path_gt / "%06d.jpg"), path_video_gt)
        subprocess.run(
            ["vmaf", "-d", str(path_video_pred), "-r", str(path_video_gt),
             "--output", str(Path(output_directory) / "vmaf.xml")],
            check=True,
        )
