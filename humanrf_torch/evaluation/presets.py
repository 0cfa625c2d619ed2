"""Frozen ActorsHQ camera splits, frame intervals, and render-sequence builders.

The camera index sets and frame intervals are dataset constants of ActorsHQ's
own `evaluation/presets.py`, as the JAX package's copy has them (they define
which images were ever allowed into training vs. evaluation, so they must
match bit-for-bit for comparable metrics). The sequence builders reproduce the published coverage
semantics: "siggraph_test" renders the hero portrait camera on every 3rd frame
plus the 13 landscape test cameras rotating over every 5th frame.
"""
from itertools import product
from typing import Dict, List, Sequence, Tuple

import numpy as np

Sequence2D = List[Tuple[int, int]]  # (camera_number, frame_number) pairs

# Camera indices are 0-based (dataset camera names are 1-indexed).
# fmt: off
camera_configs = {
    "siggraph_train": (
        1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 14, 15, 16, 17, 18, 20, 21, 22, 23, 25, 26, 27, 28, 29, 31, 32, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 45, 46, 47, 48, 49, 51, 52, 53, 54, 55, 56, 58, 59, 60, 61, 62, 65, 66, 67, 68, 69, 71,
        72, 74, 75, 76, 77, 78, 79, 80, 81, 82, 85, 86, 87, 88, 89, 91, 92, 93, 94, 95, 96, 98, 99, 100, 101, 102, 105,
        106, 107, 108, 109, 110, 111, 112, 113, 115, 116, 118, 119, 120, 121, 122, 123, 124, 125, 127, 130, 131, 132,
        133, 134, 135, 138, 139, 140, 141, 142, 143, 148, 149, 150, 151, 156, 157, 158, 159,
    ),
    "siggraph_train_validation": (
        10, 19, 33, 44, 50, 73, 83, 90, 104, 117,
    ),
    "siggraph_test": (
        0, 13, 24, 30, 43, 57, 63, 64, 70, 84, 97, 103, 114,
        126,  # hero portrait camera
    ),
    "siggraph_vmaf": (126,),
}
# fmt: on

for _name, _cams in camera_configs.items():
    assert len(set(_cams)) == len(_cams), f"duplicate camera in {_name}"

# (start inclusive, end exclusive); all published intervals start at frame 15.
frame_configs = {
    f"siggraph_interval_{i}": (15, 15 + n) for i, n in enumerate((20, 50, 100, 250, 500, 1000))
}

# Rotation order of the landscape test cameras in the published coverage.
_SIGGRAPH_LANDSCAPE_ROTATION = (0, 63, 97, 30, 13, 70, 114, 24, 84, 43, 64, 103, 57)


def get_spaced_elements(array: Sequence, count: int) -> list:
    """`count` elements spread evenly over `array` (endpoints included)."""
    picks = np.round(np.linspace(0, len(array) - 1, count)).astype(int)
    return [array[i] for i in picks]


def get_vmaf_test_sequence(frame_numbers: List[int], configs: Dict | None = None) -> Sequence2D:
    """Hero camera × every 3rd frame — the VMAF video protocol."""
    configs = configs or camera_configs
    (hero,) = configs["siggraph_vmaf"]
    return [(hero, f) for f in frame_numbers[::3]]


def _siggraph_test_sequence(frame_numbers: List[int], configs: Dict) -> Sequence2D:
    hero_part = get_vmaf_test_sequence(frame_numbers, configs)
    # The frozen ActorsHQ rotation order, restricted to cameras that exist in
    # the active test split: with the real dataset splits this keeps the
    # published order bit-for-bit; with overridden (synthetic) splits it
    # rotates over whatever non-hero test cameras the rig actually has —
    # the hardcoded camera ids 63/97/... would index past a small rig.
    test_cams = set(configs["siggraph_test"])
    (hero,) = configs["siggraph_vmaf"]
    rotation = [c for c in _SIGGRAPH_LANDSCAPE_ROTATION if c in test_cams]
    if not rotation:
        rotation = [c for c in configs["siggraph_test"] if c != hero]
    landscape_part = [
        (rotation[i % len(rotation)], f) for i, f in enumerate(frame_numbers[::5])
    ] if rotation else []
    return list(set(hero_part) | set(landscape_part))


def get_render_sequence(
    coverage: str,
    camera_preset: str,
    frame_numbers: List[int],
    repeat_cameras: int = 1,
    repeat_frames: int = 1,
    camera_configs_override: Dict | None = None,
) -> Sequence2D:
    """Build the (camera, frame) evaluation sequence for a coverage mode.

    `camera_configs_override` lets synthetic-dataset tests substitute their own
    camera splits while keeping identical coverage semantics.
    """
    configs = camera_configs_override if camera_configs_override is not None else camera_configs
    cameras = list(configs[camera_preset]) * repeat_cameras
    frames = list(frame_numbers) * repeat_frames

    if coverage == "siggraph_test":
        assert camera_preset == "siggraph_test"
        return _siggraph_test_sequence(frames, configs)
    if coverage == "exhaustive":
        return list(product(cameras, frames))
    if coverage == "uniform":
        return list(zip(cameras, get_spaced_elements(frames, len(cameras))))
    raise NotImplementedError(f"Unknown coverage: {coverage}")
