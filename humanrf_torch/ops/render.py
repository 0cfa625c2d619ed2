"""Volume rendering over a static (R, K) sample lattice (proposal mode).

Counterpart of the grid-layout part of `humanrf_tpu/ops/render.py`
(nerfacc's `render_weight_from_density` / `accumulate_along_rays` semantics,
`volume_rendering.py:123-141`): with a fixed per-ray sample count the
transmittance scan is a per-row cumsum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderOutput(NamedTuple):
    """Per-ray composited outputs (`humanrf/volume_rendering.py:14-24`)."""

    color: torch.Tensor        # (R, 3)
    weights_sum: torch.Tensor  # (R, 1)


def render_weights_grid(density: torch.Tensor, dt: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, K) density and interval lengths → compositing weights.

        alpha_i = 1 − exp(−σ_i·Δt_i),  T_i = exp(−Σ_{j<i} σ_j·Δt_j),  w = T·α
    """
    sigma_dt = density * dt
    if mask is not None:
        sigma_dt = torch.where(mask, sigma_dt, torch.zeros_like(sigma_dt))
    excl = torch.cumsum(sigma_dt, dim=-1) - sigma_dt
    weights = torch.exp(-excl) * (1.0 - torch.exp(-sigma_dt))
    if mask is not None:
        weights = torch.where(mask, weights, torch.zeros_like(weights))
    return weights


def composite_grid(weights: torch.Tensor, radiance: torch.Tensor, background_rgb) -> RenderOutput:
    """weights (R, K), radiance (R, K, 3) → per-ray color and accumulated alpha."""
    color = (weights[..., None] * radiance).sum(dim=1)
    weights_sum = weights.sum(dim=-1, keepdim=True)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)
    return RenderOutput(color=color, weights_sum=weights_sum)
