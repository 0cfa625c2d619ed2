"""Occupancy-grid space pruning.

Counterpart of `humanrf_tpu/ops/occupancy.py` (the reference's CUDA 3D
texture lookups, `occupancy_grid.cu:8-95`, and its occupancy-guided march,
`ray_sampler.cu:28-78`). Grids are stored [z][y][x] and addressed with
clamping, like the reference's texture. A corner-dilated grid turns the
texture's `trilinear(p) > 0` test into one nearest lookup, and the march
tests all K candidate positions of every ray in one batched lookup.
"""
from __future__ import annotations

import numpy as np
import torch


def coarsen_grid(grid: torch.Tensor, factor: int) -> torch.Tensor:
    """Conservative max-pool downsample of (..., res, res, res) bool grids."""
    if factor == 1:
        return grid
    res = grid.shape[-1]
    if res % factor:
        raise ValueError(f"grid resolution {res} is not a multiple of {factor}")
    lead = grid.shape[:-3]
    r = res // factor
    g = grid.reshape(*lead, r, factor, r, factor, r, factor)
    return g.any(dim=-1).any(dim=-2).any(dim=-3)


def dilate_grid(grid: torch.Tensor) -> torch.Tensor:
    """(res, res, res) uint8 {0, 255} → corner-dilated bool grid:
    dilated[i,j,k] = any(grid[i:i+2, j:j+2, k:k+2]), edge-replicated."""
    occ = grid > 0
    for axis in range(3):
        n = occ.shape[axis]
        shifted = torch.cat([occ.narrow(axis, 1, n - 1), occ.narrow(axis, n - 1, 1)], dim=axis)
        occ = occ | shifted
    return occ


def sample_occupancy(grids: torch.Tensor, grid_ids: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Nearest lookup of corner-dilated grids.

    grids: (G, res, res, res) bool, [z][y][x]; grid_ids: (...,) grid slot per
    point; points: (..., 3) = (x, y, z) in [0, 1]. → bool occupancy per point.
    """
    res = grids.shape[-1]
    ijk = torch.floor(points * res - 0.5).clamp(0, res - 1).long()
    flat_idx = (ijk[..., 2] * res + ijk[..., 1]) * res + ijk[..., 0]
    return grids.reshape(-1)[grid_ids.long() * (res * res * res) + flat_idx]


# Bisection steps refining tmin (ray_sampler.cu:49-64).
_REFINE_STEPS = 5


def occupancy_ray_minmax(origins, dirs, tmin_aabb, tmax_aabb, grids, grid_ids):
    """Occupancy-guided [tmin, tmax] per ray (ray_sampler.cu:28-78 semantics).

    Forward march from tmin at step 0.5/res to the first occupied voxel, five
    bisection steps to refine tmin, then a backward march from tmax. Every ray
    marches the same K steps, enough for the cube's diagonal.
    Returns (tmin (R,), tmax (R,)); a miss leaves tmin >= tmax.
    """
    res = grids.shape[-1]
    step = 0.5 / res
    num_steps = int(np.ceil(np.sqrt(3.0) / step)) + 2
    k = step * torch.arange(num_steps, dtype=torch.float32, device=origins.device)[None, :]

    def occupied_at(ts):
        pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None] + 0.5
        return sample_occupancy(grids, grid_ids[:, None], pts)

    def first_hit(ts, hit):
        """(any hit per ray, ts at the first hit)."""
        first = torch.argmax(hit.to(torch.uint8), dim=1, keepdim=True)
        return hit.any(dim=1), torch.gather(ts, 1, first)[:, 0]

    ts_fwd = tmin_aabb[:, None] + k  # (R, K)
    any_hit, tmin = first_hit(ts_fwd, occupied_at(ts_fwd) & (ts_fwd < tmax_aabb[:, None]))

    # Bisection refine of tmin (ray_sampler.cu:49-64).
    refine = -0.5 * step * torch.ones_like(tmin)
    t = tmin
    for _ in range(_REFINE_STEPS):
        t = t + refine
        occ = sample_occupancy(grids, grid_ids, origins + dirs * t[:, None] + 0.5)
        refine = torch.where(occ, -refine.abs() * 0.5, refine.abs() * 0.5)
    tmin = torch.where(any_hit, t, tmax_aabb)  # miss → tmin = tmax → masked

    # Backward march for tmax (ray_sampler.cu:66-75).
    ts_bwd = tmax_aabb[:, None] - k
    any_hit_bwd, tmax = first_hit(ts_bwd, occupied_at(ts_bwd) & (ts_bwd > tmin[:, None]))
    tmax = torch.where(any_hit & any_hit_bwd, tmax, tmin)
    return tmin, tmax
