"""Per-frame axis-aligned bounding boxes, stored as CSV.

Counterpart of `humanrf_tpu/core/aabb.py`. On-disk schema (one row per
frame, the ActorsHQ dataset layout): a ``frame_number`` column
followed by ``aabb_{min,max}_{x,y,z}``. In memory an AABB is a (2, 3) float
array — row 0 the minimum corner, row 1 the maximum.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List

import numpy as np

# Column order: min corner then max corner, xyz within each.
_CORNER_COLUMNS = [f"aabb_{corner}_{axis}" for corner in ("min", "max") for axis in "xyz"]
_ALL_COLUMNS = ["frame_number"] + _CORNER_COLUMNS


@dataclass
class AabbData:
    frame_number: int
    aabb: np.ndarray  # (2, 3): [min_xyz, max_xyz]


def read_aabbs_csv(input_csv_path: Path) -> List[AabbData]:
    with open(input_csv_path, "r", newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return [
        AabbData(
            frame_number=int(row["frame_number"]),
            aabb=np.fromiter((float(row[c]) for c in _CORNER_COLUMNS), dtype=np.float64).reshape(2, 3),
        )
        for row in rows
    ]


def write_aabbs_csv(aabbs: Iterable[AabbData], output_csv_path: Path) -> None:
    with open(output_csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=_ALL_COLUMNS)
        writer.writeheader()
        for entry in aabbs:
            corners = np.asarray(entry.aabb).reshape(6)
            row = {"frame_number": str(entry.frame_number)}
            row.update({col: str(v) for col, v in zip(_CORNER_COLUMNS, corners)})
            writer.writerow(row)
