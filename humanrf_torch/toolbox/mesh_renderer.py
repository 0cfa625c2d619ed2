#!/usr/bin/env python3
"""Offscreen mesh renderer: an OBJ animation → per-camera masks and depth maps.

The port's counterpart of `humanrf_tpu/native/mesh_renderer` (the CLI of its
`main.cpp:289-378`), with the rasterizer back on the GPU where the
reference has it: every selected camera of a frame is drawn in one pass of
the `mesh_raster` kernels (`ops/rasterize.py`), or of its plain PyTorch
version with `--device cpu`. The masks decode to the native tool's pixels
and the depth maps are its bytes:

    <output>/masks/<Cam>/<Cam>_mask%06d.png    (0/255 coverage)
    <output>/depths/<Cam>/<Cam>_depth%06d.pfm  (camera-space z, float32, 0 where uncovered)

Frames are positions in the sorted OBJ list; cameras keep the CSV's order.

    python -m humanrf_torch.toolbox.mesh_renderer --objs f1.obj [f2.obj ...] --csv calibration.csv \\
        --output <dir> [--mask] [--depth] [--scale S] [--cameras Cam001 ...] [--frames 0 1 ...] [--device cuda|cpu]
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from humanrf_torch.core import image_io
from humanrf_torch.ops import rasterize as raster
from humanrf_torch.toolbox import mesh_io

USAGE = ("usage: mesh_renderer --objs <f1.obj> [f2.obj ...] --csv calibration.csv --output <dir> [--mask] "
         "[--depth] [--scale S] [--cameras Cam001 ...] [--frames 0 1 ...] [--device cuda|cpu]")
ALEMBIC_ADVICE = ("--alembic requires the Alembic library; extract to OBJs first (see alembic_extractor) "
                  "and use --objs.")


def render_frames(obj_paths: Sequence, csv_path, output: Path, mask: bool, depth: bool, scale: float = 1.0,
                  camera_names: Optional[Iterable[str]] = None, frames: Optional[Iterable[int]] = None,
                  device="cuda") -> None:
    """Render every selected frame (a position in the sorted OBJ list) in
    every selected camera into `output`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU (pass --device cpu to rasterize on the CPU)")
    cameras = mesh_io.read_calibration_f32(csv_path)
    if camera_names:
        names = set(camera_names)
        cameras = [cam for cam in cameras if cam.name in names]
    frame_set = set(frames) if frames else None
    with ThreadPoolExecutor(max(1, min(len(cameras), os.cpu_count() or 1))) as writers:
        for frame, path in enumerate(sorted(obj_paths, key=os.fsencode)):
            if frame_set is not None and frame not in frame_set:
                continue
            vertices, faces = mesh_io.load_obj(path)
            print(f"Rendering animation at frame: {frame} ({len(faces)} tris)", flush=True)
            views = raster.rasterize(torch.from_numpy(vertices).to(device), torch.from_numpy(faces).to(device),
                                     cameras, scale)
            pending = []
            for cam, (cam_mask, cam_depth) in zip(cameras, views):
                if mask:
                    pending.append(writers.submit(_write, _write_mask, Path(output) / "masks" / cam.name /
                                                  f"{cam.name}_mask{frame:06d}.png", cam_mask.cpu().numpy()))
                if depth:
                    pending.append(writers.submit(_write, mesh_io.write_pfm, Path(output) / "depths" / cam.name /
                                                  f"{cam.name}_depth{frame:06d}.pfm", cam_depth.cpu().numpy()))
            for job in pending:
                job.result()


def _write_mask(path: Path, mask: np.ndarray) -> None:
    path.write_bytes(image_io.encode_png(mask))


def _write(writer, path: Path, image: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    writer(path, image)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    objs, cameras, frames = [], [], []
    csv = output = None
    mask = depth = False
    scale, device = 1.0, "cuda"
    i = 0

    def values():
        nonlocal i
        out = []
        while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
            i += 1
            out.append(argv[i])
        return out

    def value():
        nonlocal i
        if i + 1 >= len(argv):
            raise ValueError(f"{argv[i]} needs a value")
        i += 1
        return argv[i]

    try:
        while i < len(argv):
            arg = argv[i]
            if arg == "--objs":
                objs += values()
            elif arg == "--csv":
                csv = value()
            elif arg == "--output":
                output = value()
            elif arg == "--depth":
                depth = True
            elif arg == "--mask":
                mask = True
            elif arg == "--headless":
                pass  # accepted: the renderer is always offscreen
            elif arg == "--scale":
                scale = float(mesh_io.strtof(value().encode()))
            elif arg == "--cameras":
                cameras += values()
            elif arg == "--frames":
                frames += [mesh_io.stoi(v.encode()) for v in values()]
            elif arg == "--device":
                device = value()
            elif arg == "--alembic":
                print(ALEMBIC_ADVICE, file=sys.stderr)
                return 2
            else:
                print(f"unknown argument: {arg}", file=sys.stderr)
                return 2
            i += 1
    except ValueError as e:
        print(f"{e}\n{USAGE}", file=sys.stderr)
        return 2
    if csv is None or output is None or not objs:
        print(USAGE, file=sys.stderr)
        return 2
    if not (mask or depth):
        print("nothing to do: pass --mask and/or --depth", file=sys.stderr)
        return 2
    render_frames(objs, csv, Path(output), mask, depth, scale, cameras, frames, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
