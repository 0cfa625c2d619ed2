"""The two OpenCV raster operations the JAX package uses on masks, in numpy
and scipy, with OpenCV's results bit for bit:

- `erode(img, k)` / `dilate(img, k)`: `cv2.erode` / `cv2.dilate` by a k×k
  square of ones, one iteration. The window of pixel i spans
  [i − k//2, i − k//2 + k − 1] on each axis (OpenCV's default anchor, so an
  even k reaches one pixel further back than forward), and pixels outside
  the image take no part (OpenCV's default border value). k = 0 (an empty
  kernel) means OpenCV's default 3×3 square.
- `fill_circle(img, center, radius, value)`: `cv2.circle(img, center,
  radius, value, thickness=-1)` with the default 8-connected line type and
  no sub-pixel shift: OpenCV's integer midpoint walk, which fills the rows
  cy ± dy from cx − dx to cx + dx and the rows cy ± dx from cx − dy to
  cx + dy at each step, clipped to the image. Its disc is not the set
  x² + y² ≤ r².
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def _square_filter(img: np.ndarray, k: int, filter1d) -> np.ndarray:
    if k == 0:
        k = 3  # OpenCV's default kernel for an empty one
    out = np.asarray(img)
    if out.ndim == 3 and out.shape[2] == 1:
        out = out[..., 0]  # OpenCV returns a one-channel image as (H, W)
    # mode "nearest" repeats the edge pixel, which the window already holds:
    # outside pixels change nothing, as with OpenCV's border value.
    for axis in (0, 1):
        out = filter1d(out, size=k, axis=axis, mode="nearest")
    return out


def erode(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.erode(img, np.ones((k, k), np.uint8))`: the minimum over each
    pixel's k×k window; (H, W) or (H, W, 1) in, (H, W) out."""
    return _square_filter(img, k, ndimage.minimum_filter1d)


def dilate(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.dilate(img, np.ones((k, k), np.uint8))`: the maximum over each
    pixel's k×k window; (H, W) or (H, W, 1) in, (H, W) out."""
    return _square_filter(img, k, ndimage.maximum_filter1d)


def _circle_half_widths(radius: int) -> dict:
    """{row offset: half width} of OpenCV's filled circle of `radius`."""
    half = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for offset, width in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            half[offset] = max(half.get(offset, -1), width)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return half


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int, value) -> np.ndarray:
    """`cv2.circle(img, center, radius, value, -1)`: fills `img` (H, W) or
    (H, W, C) in place and returns it. `center` is (x, y); it may lie off
    the image."""
    if radius < 0:
        raise ValueError(f"circle radius must be >= 0, got {radius}")
    height, width = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    for offset, half in _circle_half_widths(int(radius)).items():
        y = cy + offset
        x0, x1 = max(cx - half, 0), min(cx + half, width - 1)
        if 0 <= y < height and x0 <= x1:
            img[y, x0 : x1 + 1] = value
    return img
