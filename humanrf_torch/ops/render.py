"""Volume rendering: nerfacc's semantics over the port's two sample layouts.

Counterpart of `humanrf_tpu/ops/render.py` (nerfacc 0.3.1's
`render_visibility`, `render_weight_from_density` and
`accumulate_along_rays`, `volume_rendering.py:75-81,123-141` of the
reference):

- the flat, compacted buffer of dense sampling (`ops/sampling.py`): each
  ray's samples are contiguous and in ascending t, so the transmittance scan
  is a within-ray cumulative sum, and accumulation a sum into the rays' rows;
  `prune_samples` and `render` are the reference's `volume_rendering.py:
  42-150`;
- the static (R, K) lattice of proposal sampling: the scan is a per-row
  cumsum (`render_weights_grid`, `composite_grid`).

The within-ray scan does not take one fp32 cumsum over the whole buffer minus
each ray's offset: over ~10^6 samples that cancels catastrophically. It
scatters each sample to its slot in an (R, samples_per_ray) layout (a ray
holds at most samples_per_ray contiguous samples), takes `torch.cumsum` along
the rows and gathers back, differentiably. The per-ray sums use the same
layout, summed along the rows: unlike `index_add`'s atomics on the card,
that adds in a fixed order, so a render is the same from run to run. The
JAX package's segmented `associative_scan` and `segment_sum` add in other
orders, so the two differ by fp32 roundings.

A flat pass queries the field on the buffer's valid prefix only (one host
read of `num_valid` per pass): empty slots carry weight 0, so the outputs and
gradients are those of a query on every slot.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from humanrf_torch.ops.sampling import SampleSet, compact_flat_samples


class RenderOutput(NamedTuple):
    """Per-ray composited outputs (`humanrf/volume_rendering.py:14-24`)."""

    color: torch.Tensor        # (R, 3)
    weights_sum: torch.Tensor  # (R, 1)


# ---------------------------------------------------------------------------
# Flat layout: dense sampling.
# ---------------------------------------------------------------------------


def _to_rows(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, max_length: int):
    """Scatter `values` (S, ...) into (num_segments + 1, max_length, ...)
    rows, entry i of a segment at column i → (rows, (row, col) per value).

    `segment_ids` ascend (ray-major buffers do), and a segment id in
    [0, num_segments) has at most `max_length` entries. Values of any other
    id (the empty tail, id == num_segments) must be 0; they all go to column
    0 of the last row."""
    ids = segment_ids.long()
    slot = torch.arange(ids.shape[0], device=ids.device) - torch.searchsorted(ids, ids)
    inside = ids < num_segments
    row = torch.where(inside, ids, num_segments)
    col = torch.where(inside, slot, 0)
    rows = values.new_zeros((num_segments + 1, max_length, *values.shape[1:])).index_put((row, col), values)
    return rows, (row, col)


def segmented_cumsum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, max_length: int) -> torch.Tensor:
    """Inclusive cumsum that restarts at each run of equal `segment_ids` (see
    `_to_rows` for what they must satisfy)."""
    rows, index = _to_rows(values, segment_ids, num_segments, max_length)
    return torch.cumsum(rows, dim=1)[index]


def _per_ray_exclusive_cumsum(values, sample_ray, num_rays: int, max_length: int) -> torch.Tensor:
    """Exclusive within-ray cumsum of per-sample `values` (empty slots hold 0)."""
    return segmented_cumsum(values, sample_ray, num_rays, max_length) - values


def render_weights_from_density(
    density: torch.Tensor, samples: SampleSet, num_rays: int, render_step_size: float, max_length: int
) -> torch.Tensor:
    """nerfacc.render_weight_from_density with t_end − t_start = render_step_size:

        alpha_i = 1 − exp(−σ_i·Δt),  T_i = exp(−Σ_{j<i} σ_j·Δt),  w_i = T_i·α_i
    """
    sigma_dt = torch.where(samples.valid, density * render_step_size, 0.0)
    excl = _per_ray_exclusive_cumsum(sigma_dt, samples.ray, num_rays, max_length)
    weights = torch.exp(-excl) * (1.0 - torch.exp(-sigma_dt))
    return torch.where(samples.valid, weights, 0.0)


def accumulate_along_rays(
    weights: torch.Tensor, sample_ray: torch.Tensor, num_rays: int, max_length: int,
    values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """nerfacc.accumulate_along_rays: per-ray sum of weights·values → (num_rays,
    D), or of weights → (num_rays, 1), in a fixed order. Empty slots (weight
    0) are dropped."""
    src = weights[:, None] if values is None else weights[:, None] * values
    rows, _ = _to_rows(src, sample_ray, num_rays, max_length)
    return rows.sum(dim=1)[:num_rays]


def render_visibility(
    alphas: torch.Tensor,
    samples: SampleSet,
    num_rays: int,
    max_length: int,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 1e-4,
) -> torch.Tensor:
    """nerfacc.render_visibility: a sample is visible iff its alpha ≥
    alpha_thre and the transmittance over the kept samples before it is >
    early_stop_eps."""
    keep = samples.valid & (alphas >= alpha_thre)
    neg_log = torch.where(keep, -torch.log1p(-torch.clamp(alphas, 0.0, 1.0 - 1e-7)), 0.0)
    excl = _per_ray_exclusive_cumsum(neg_log, samples.ray, num_rays, max_length)
    return keep & (torch.exp(-excl) > early_stop_eps)


def _valid_prefix(samples: SampleSet) -> SampleSet:
    """The first num_valid slots (a host read of num_valid)."""
    n = int(samples.num_valid)
    return samples._replace(t=samples.t[:n], ray=samples.ray[:n], valid=samples.valid[:n])


def _sample_rays(samples: SampleSet, origins, dirs, num_rays: int):
    ray_idx = samples.ray.long().clamp(0, num_rays - 1)
    sample_dirs = dirs[ray_idx]
    return ray_idx, origins[ray_idx] + samples.t[:, None] * sample_dirs, sample_dirs


def prune_samples(
    density_fn,
    samples: SampleSet,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    frame_numbers: torch.Tensor,
    num_rays: int,
    budget: int,
    render_step_size: float,
    max_length: int,
) -> SampleSet:
    """The reference's `prune_samples` (`volume_rendering.py:42-84`): query
    the density only, cull invisible samples, compact into `budget` slots.

    `density_fn(positions, frame_numbers) -> density`; the caller runs this
    under `torch.no_grad()`. Training jitter is the caller's (the pipeline
    keys it by ray identity), so there is no key here.
    """
    prefix = _valid_prefix(samples)
    ray_idx, positions, _ = _sample_rays(prefix, origins, dirs, num_rays)
    density = density_fn(positions, frame_numbers[ray_idx])
    alphas = 1.0 - torch.exp(-density * render_step_size)
    visible = render_visibility(alphas, prefix, num_rays, max_length)
    return compact_flat_samples(prefix, visible, budget)


def render(
    forward_fn,
    samples: SampleSet,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    frame_numbers: torch.Tensor,
    camera_numbers: torch.Tensor,
    num_rays: int,
    background_rgb,
    render_step_size: float,
    max_length: int,
) -> RenderOutput:
    """The reference's `render` (`volume_rendering.py:87-150`).

    `forward_fn(positions, directions, frame_numbers, camera_numbers) ->
    (density, radiance)`; `background_rgb` is a scalar or (R, 3), blended by
    (1 − weights_sum).
    """
    prefix = _valid_prefix(samples)
    ray_idx, positions, sample_dirs = _sample_rays(prefix, origins, dirs, num_rays)
    density, radiance = forward_fn(positions, sample_dirs, frame_numbers[ray_idx], camera_numbers[ray_idx])
    weights = render_weights_from_density(density, prefix, num_rays, render_step_size, max_length)
    color = accumulate_along_rays(weights, prefix.ray, num_rays, max_length, values=radiance)
    weights_sum = accumulate_along_rays(weights, prefix.ray, num_rays, max_length)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)
    return RenderOutput(color=color, weights_sum=weights_sum)


# ---------------------------------------------------------------------------
# Grid layout: proposal sampling, a static (R, K) lattice.
# ---------------------------------------------------------------------------


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
