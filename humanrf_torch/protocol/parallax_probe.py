"""PSNR against the angle to the nearest training camera
(`scripts/parallax_probe.py`).

The r4 run validated at 25.81 dB (best block) but its evaluate phase scored
19.22 dB on the one held-out test camera. Two effects are entangled there,
besides the metrics' definitions (`metric_style`): quality should decay
smoothly with the angular distance from the nearest training camera of a
12-camera rig (parallax), and the test view may fall below that curve
(overfit).

This probe mints held-out cameras at set angular offsets from a training
azimuth (the ring has 12 slots every 30°; the training slots are {0, 1, 2,
4, 5, 7, 9, 10}, `run.py::derive_synthetic_presets`), renders them from the
banked best checkpoint through the port's render path, and reports both
metric styles per view: base 60° (training camera 2) plus offsets {0, 5,
…, 30}°, and a replica of the r4 test camera (330°).

    python -m humanrf_torch.protocol.parallax_probe [--frames 0 12 25 37 49] [--root protocol_runs/parallax_probe]
        [--best <ckpt>] [--device cpu]

writes the probe scene under <root>/scene and the rows to <out> (default
<root>/results.json).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from humanrf_torch.configs.args import parse_args
from humanrf_torch.convert import convert_params
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.core.synthetic import SyntheticSceneConfig
from humanrf_torch.data.loader import DataLoader
from humanrf_torch.evaluation.metrics import bounding_rect, compute_psnr, compute_ssim
from humanrf_torch.protocol import common
from humanrf_torch.r4 import NUM_FRAMES, r4_flags
from humanrf_torch.run import build_model, build_pipeline_config, resolve_device
from humanrf_torch.train.checkpoint import load_checkpoint
from humanrf_torch.train.pipeline import make_render_fn
from humanrf_torch.train.trainer import render_pipeline_config

BEST_CKPT = common.R4_RUN / "best.ckpt"

TRAIN_SLOTS = (0, 1, 2, 4, 5, 7, 9, 10)  # derive_synthetic_presets on 12 cameras
BASE_DEG = 60.0  # training camera 2's azimuth
OFFSETS_DEG = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
TEST_DEG = 330.0  # the r4 test camera's azimuth (camera 11)


def probe_angles_deg() -> list:
    return [BASE_DEG + o for o in OFFSETS_DEG] + [TEST_DEG]


def probe_scene_config(frames: int = NUM_FRAMES, size: int = 748) -> SyntheticSceneConfig:
    """The r4 scene (its subject, motion and detail), seen by the probe
    cameras instead of the uniform ring."""
    return dataclasses.replace(common.detail_scene(size, size, frames, 0.16), num_cameras=len(probe_angles_deg()),
                               camera_angles=tuple(math.radians(a) for a in probe_angles_deg()))


def eye_at(deg: float, distance: float = 3.0) -> np.ndarray:
    a = math.radians(deg)
    return np.array([distance * math.cos(a), distance * math.sin(a), 0.4 * math.sin(2 * a + 0.5)])


def nearest_training_angle_deg(deg: float) -> float:
    """The 3D angle (about the scene's origin) to the nearest training camera."""
    v = eye_at(deg)
    best = 180.0
    for slot in TRAIN_SLOTS:
        u = eye_at(slot * 30.0)
        cos = float(np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)))
        best = min(best, math.degrees(math.acos(max(-1.0, min(1.0, cos)))))
    return round(best, 2)


def probe(scene: Path, best: Path, frames, size: int, rays: int, device: str, out: Path | None = None) -> list:
    """Render every probe camera at `frames` from `best` → one row per view:
    azimuth, nearest training angle, frame, ROI PSNR (validation style),
    masked PSNR (evaluation style) and SSIM."""
    # The r4 protocol model: L8/F4, log2 13 over the [25, 25] segments of
    # the 50-frame scene, as the r4 command builds it.
    config = parse_args(r4_flags(scene, scene.parent / "unused", 1, 1, device))
    torch_device = resolve_device(device)
    model = build_model(config, (25, 25), torch_device)
    params, _, step, _, stats = load_checkpoint(best)
    model.load_state_dict(convert_params(params))
    model.eval()
    print(f"# loaded {best} at step {step} (best_psnr={stats.get('best_psnr'):.2f})", flush=True)
    # Validation and test renders take every pixel: one candidate per ray.
    pcfg = dataclasses.replace(build_pipeline_config(config), candidate_rays_factor=1)

    dataset = VolumetricDataset(scene / "SynthActor" / "Sequence1" / "1x")
    n_cams = len(dataset.cameras)
    render_sequence = [(c, f) for c in range(n_cams) for f in frames]
    loader = DataLoader(
        dataset=dataset, mode=DataLoader.Mode.VALIDATION, space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID,
        batch_size=rays, camera_numbers=tuple(range(n_cams)), frame_numbers=tuple(frames), max_buffer_size=1,
        use_mask=True, filter_light_bloom=False, render_sequence=render_sequence, seed=123, device=torch_device)
    render_fn = make_render_fn(render_pipeline_config(pcfg, rays), model, size, size)
    aabb = loader.device_aabb

    angles = probe_angles_deg()
    rows, partial_colors, partial_rgba = [], [], []
    img_idx = 0
    try:
        for data_idx, (batch, pool, grids, info) in enumerate(loader):
            out_batch, _ = render_fn(batch, pool, grids, aabb, 0.0)
            partial_colors.append(out_batch.color[: info.num_real])
            partial_rgba.append(batch.rgba[: info.num_real])
            if (data_idx + 1) % loader.num_batches_per_full_image != 0:
                continue
            colors = torch.cat(partial_colors).cpu().numpy()
            rgba = torch.cat(partial_rgba).cpu().numpy()
            partial_colors, partial_rgba = [], []

            cam_idx, frame = render_sequence[img_idx]
            img_idx += 1
            gt = (rgba[:, 0:3] * rgba[:, 3:4]).reshape(size, size, 3)
            mask = rgba[:, 3].reshape(size, size)
            pred = colors.reshape(size, size, 3)
            x, y, w, h = bounding_rect(mask > 0)
            pred_roi, gt_roi = pred[y : y + h, x : x + w], gt[y : y + h, x : x + w]
            mask_roi = (mask[y : y + h, x : x + w, None] > 0).astype(np.uint8)
            row = {
                "azimuth_deg": angles[cam_idx],
                "nearest_train_deg": nearest_training_angle_deg(angles[cam_idx]),
                "frame": frame,
                "psnr_roi": round(float(compute_psnr(pred_roi, gt_roi)), 3),
                "psnr_masked": round(float(compute_psnr(pred_roi, gt_roi, mask=mask_roi)), 3),
                "ssim": round(float(compute_ssim(pred_roi, gt_roi, data_range=1.0)), 4),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            if out is not None:
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps(rows, indent=2))
    finally:
        loader.shutdown()
    return rows


def summary(rows: list) -> list:
    """Per camera, the mean over frames of both metric styles → table lines."""
    lines = ["| azimuth | nearest-train | PSNR (ROI, val-style) | PSNR (masked, eval-style) | SSIM |",
             "|---|---|---|---|---|"]
    for az in probe_angles_deg():
        sel = [r for r in rows if r["azimuth_deg"] == az]
        if not sel:
            continue
        m = lambda k: sum(r[k] for r in sel) / len(sel)  # noqa: E731
        lines.append(f"| {az:.0f}° | {sel[0]['nearest_train_deg']}° | {m('psnr_roi'):.2f} "
                     f"| {m('psnr_masked'):.2f} | {m('ssim'):.4f} |")
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[0, 12, 25, 37, 49])
    ap.add_argument("--root", type=Path, default=common.RUNS / "parallax_probe")
    ap.add_argument("--out", type=Path, default=None, help="default <root>/results.json")
    ap.add_argument("--size", type=int, default=748)
    ap.add_argument("--rays", type=int, default=16384, help="render batch size")
    ap.add_argument("--best", type=Path, default=BEST_CKPT, help="the r4 checkpoint to render")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    scene = args.root / "scene"
    if common.ensure_scene(scene, {"probe": probe_angles_deg(), "size": args.size, "frames": NUM_FRAMES},
                           lambda root: common.write_scene(root, probe_scene_config(NUM_FRAMES, args.size),
                                                           args.device)):
        print("# generated probe scene", flush=True)
    rows = probe(scene, args.best, args.frames, args.size, args.rays, args.device,
                 args.out or args.root / "results.json")
    print("\n" + "\n".join(summary(rows)))
    return rows


if __name__ == "__main__":
    main()
