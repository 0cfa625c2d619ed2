"""Adaptive temporal partitioning (HumanRF paper Eq. 2-4).

Counterpart of `humanrf_tpu/train/partitioning.py` over the port's dataset
reader: greedily grow a cluster of frames, tracking the union of their occupancy grids;
when occupied(union)/occupied(first frame) exceeds the expansion threshold (or
the cluster hits the max predefined size), emit a segment whose size is snapped
down to the predefined ladder {6, 12, 25, 50, 100} and restart from the first
frame not yet covered.
"""
from __future__ import annotations

from typing import List

from humanrf_torch.core.dataset import VolumetricDataset

PREDEFINED_SEGMENT_SIZES = [6, 12, 25, 50, 100]


def get_segment_size(num_frames: int) -> int:
    """Largest predefined size that is <= the next ladder rung above num_frames."""
    for idx, segment_size in enumerate(PREDEFINED_SEGMENT_SIZES[:-1]):
        if num_frames < PREDEFINED_SEGMENT_SIZES[idx + 1]:
            return segment_size
    return PREDEFINED_SEGMENT_SIZES[-1]


def get_final_segment_size(num_frames_left: int) -> int:
    for segment_size in PREDEFINED_SEGMENT_SIZES:
        if num_frames_left <= segment_size:
            return segment_size
    return PREDEFINED_SEGMENT_SIZES[-1]


def compute_adaptive_segment_sizes(
    dataset: VolumetricDataset,
    sorted_frame_numbers: List[int],
    expansion_factor_threshold: float = 1.25,
) -> List[int]:
    min_segment_size = min(PREDEFINED_SEGMENT_SIZES)
    max_segment_size = max(PREDEFINED_SEGMENT_SIZES)

    union_grid = None
    cluster_frames: List[int] = []
    initial_occupancy = 0
    segment_sizes: List[int] = []

    fnum_idx = 0
    total = len(sorted_frame_numbers)
    total_decided = 0
    while fnum_idx < total:
        frame_number = sorted_frame_numbers[fnum_idx]
        grid = dataset.get_occupancy_grid(frame_number=frame_number)
        occupied = grid == 255
        if not cluster_frames:
            initial_occupancy = int(occupied.sum())
            union_grid = occupied
        else:
            union_grid = union_grid | occupied
        cluster_frames.append(frame_number)

        if len(cluster_frames) >= min_segment_size:
            expansion_factor = int(union_grid.sum()) / max(initial_occupancy, 1)
            if expansion_factor > expansion_factor_threshold or len(cluster_frames) >= max_segment_size:
                segment_size = get_segment_size(len(cluster_frames))
                total_decided += segment_size
                cluster_frames = []
                union_grid = None
                fnum_idx = total_decided
                segment_sizes.append(segment_size)
                continue
        fnum_idx += 1

    if total_decided < total:
        segment_sizes.append(get_final_segment_size(total - total_decided))

    assert sum(segment_sizes) >= total
    return segment_sizes
