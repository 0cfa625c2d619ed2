#!/usr/bin/env python3
"""ActorsHQ download manager.

The port's copy of `humanrf_tpu/data/download_manager.py`, standard library
only: given the signed-URL YAML file from the ActorsHQ website, it
assembles the dataset layout on disk (per-frame rgb/mask tars fanned out
into per-camera folders, calibration, scene metadata, occupancy grids,
aabbs, light annotations and optionally the alembic meshes). An artifact
that already exists is not fetched again, so an interrupted download
resumes. The YAML file is read by `read_links_yaml`, a reader of the subset
such a file uses (nested block mappings of string scalars), in place of
PyYAML.

    python -m humanrf_torch.data.download_manager links.yaml <target> --actor Actor01 --sequence Sequence1 --scale 4
"""
from __future__ import annotations

import argparse
import io
import json
import lzma
import tarfile
from pathlib import Path
from typing import Sequence

from humanrf_torch.core.dataset import VolumetricDatasetFilepaths

_UNAVAILABLE = {("Actor03", "Sequence2"), ("Actor07", "Sequence2")}


def _scalar(text: str) -> str:
    """A YAML flow scalar: plain, 'single-quoted' or "double-quoted"."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    return text


def read_links_yaml(text: str) -> dict:
    """Nested block mappings of scalars (`key: value`, `key:` then an
    indented block, `key: {}`) → nested dicts of strings. Comments and blank
    lines are skipped; anything else (sequences, flow collections, multi-line
    scalars) raises ValueError."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    for number, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = stripped.partition(":")
        if not sep or stripped.startswith(("- ", "[", "{")):
            raise ValueError(f"line {number}: not a `key: value` mapping entry: {line!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        mapping = stack[-1][1]
        key, value = _scalar(key.strip()), value.strip()
        if value in ("", "{}"):
            mapping[key] = {}
            if not value:
                stack.append((indent, mapping[key]))
        else:
            mapping[key] = _scalar(value)
    return root


class _Fetcher:
    """Lazy HTTP fetcher: a target that already exists is never re-fetched."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose

    def fetch(self, url: str, target: Path) -> Path:
        if not target.exists():
            if self.verbose:
                print(f"Downloading {target.name} ...")
            from urllib.request import urlopen

            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(target.suffix + ".part")
            with urlopen(url) as response, open(tmp, "wb") as f:
                while chunk := response.read(1 << 20):
                    f.write(chunk)
            tmp.rename(target)
        return target

    def fetch_bytes(self, url: str) -> bytes:
        from urllib.request import urlopen

        with urlopen(url) as response:
            return response.read()


def _extract_view_tar(tar_bytes: bytes, kind_root: Path) -> None:
    """Fan a per-frame tar of view images out into per-camera folders: a
    member ``Cam{NNN}_{rgb|mask}{FFFFFF}.{jpg|png}`` goes to ``Cam{NNN}/``."""
    with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            camera_name = Path(member.name).name.split("_", 1)[0]
            dest_dir = kind_root / camera_name
            dest_dir.mkdir(parents=True, exist_ok=True)
            (dest_dir / Path(member.name).name).write_bytes(tar.extractfile(member).read())


def download_dataset(
    dataset_file: Path,
    dataset_target: Path,
    actor: str,
    sequence: str,
    scale: int,
    frame_start: int = 0,
    frame_stop: int = 0,
    include_rgb: bool = True,
    include_mask: bool = True,
    include_mesh: bool = False,
    include_lightannotations: bool = True,
) -> Path:
    """Download one sequence at one scale → its `<actor>/<sequence>/<scale>x`
    folder. `frame_stop` 0 means the sequence's last frame (scene.json)."""
    if (actor, sequence) in _UNAVAILABLE:
        raise RuntimeError(f"{actor}{sequence} is not publicly available!")

    print("Reading links ...")
    seq_links = read_links_yaml(Path(dataset_file).read_text(encoding="UTF-8"))[actor][sequence]
    scale_links = seq_links[f"{scale}x"]

    sequence_dir = Path(dataset_target) / actor / sequence
    scale_dir = sequence_dir / f"{scale}x"
    paths = VolumetricDatasetFilepaths(scale_dir)
    scale_dir.mkdir(parents=True, exist_ok=True)

    fetcher = _Fetcher()

    # Sequence-level metadata first: scene.json bounds the frame range.
    fetcher.fetch(seq_links["scene"], paths.metadata_path)
    if frame_stop == 0:
        frame_stop = json.loads(paths.metadata_path.read_text())["num_frames"]

    # Per-frame view tars. Existence of the Cam001 image is the resume marker.
    view_kinds = []
    if include_rgb:
        view_kinds.append(("rgbs", paths.get_rgb_path))
    if include_mask:
        view_kinds.append(("masks", paths.get_mask_path))
    for frame in range(frame_start, frame_stop):
        for kind, probe in view_kinds:
            if probe("Cam001", frame).exists():
                continue
            _extract_view_tar(fetcher.fetch_bytes(scale_links[kind][f"{kind}_{frame:06d}"]), scale_dir / kind)

    fetcher.fetch(scale_links["calibration"], paths.calibration_path)
    fetcher.fetch(seq_links["aabbs"], paths.aabbs_path)
    if include_lightannotations:
        fetcher.fetch(scale_links["light_annotations"], paths.get_light_annotations_path())

    if not paths.get_occupancy_grid_path(0).exists():
        with tarfile.open(fileobj=io.BytesIO(fetcher.fetch_bytes(seq_links["occupancy_grids"])), mode="r:gz") as tar:
            tar.extractall(sequence_dir, filter="data")

    if include_mesh:
        mesh_path = sequence_dir / "meshes.abc"
        if not mesh_path.exists():
            mesh_path.write_bytes(lzma.decompress(fetcher.fetch_bytes(seq_links["meshes"])))

    return scale_dir


def main(argv: Sequence[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset_file", type=Path)
    parser.add_argument("target", type=Path)
    parser.add_argument("--actor", choices=[f"Actor{i:02d}" for i in range(1, 9)], required=True)
    parser.add_argument("--sequence", choices=["Sequence1", "Sequence2"], required=True)
    parser.add_argument("--scale", type=int, choices=[1, 2, 4], default=4)
    parser.add_argument("--frame_start", type=int, default=0)
    parser.add_argument("--frame_stop", type=int, default=0)
    parser.add_argument("--include", default=["rgb", "mask"], choices=["mesh", "rgb", "mask"], nargs="*")
    args = parser.parse_args(argv)

    download_dataset(
        args.dataset_file,
        args.target,
        args.actor,
        args.sequence,
        args.scale,
        args.frame_start,
        args.frame_stop,
        include_rgb="rgb" in args.include,
        include_mask="mask" in args.include,
        include_mesh="mesh" in args.include,
    )


if __name__ == "__main__":
    main()
