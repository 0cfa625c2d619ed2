"""Static-size sample generation and compaction for dense sampling.

Counterpart of `humanrf_tpu/ops/sampling.py` (the reference's CSR sample
pipeline, `ray_sampler.cu:150-194,283-323`, recast with static shapes):

1. each ray expands into a candidate lattice ``t = tmin + j·step``
   (j < samples_per_ray);
2. every candidate is occupancy-tested in one batched lookup;
3. the surviving samples are compacted into a flat buffer of ``budget``
   slots, ray-major and ascending in t, so each ray's samples stay
   contiguous and sorted (what the within-ray scans of `ops/render.py` need).

The valid samples form a prefix of the buffer (`num_valid` of them). Empty
slots carry ``ray == num_rays`` and ``t = 0``. A ray whose samples did not all
fit the budget has ``ray_included`` false, so the loss can leave it out (the
reference truncates the merged batch at a ray boundary, `humanrf/input.py:
33-47`). JAX's ``.at[target].set(..., mode="drop")`` is a scatter into
``budget`` slots and a drop slot per value, which are sliced off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hrfbench.reference.occupancy import sample_occupancy


class SampleSet(NamedTuple):
    """A flat, static-size set of ray-marching samples."""

    t: torch.Tensor             # (S,) float32: distance along the owning ray
    ray: torch.Tensor           # (S,) int32: owning ray; == num_rays for empty slots
    valid: torch.Tensor         # (S,) bool: the first num_valid slots
    ray_included: torch.Tensor  # (R,) bool: the ray's samples all fit the budget
    num_valid: torch.Tensor     # () int32


def _compact(values, keep: torch.Tensor, pos: torch.Tensor, budget: int, fills):
    """Scatter each of `values` (flat) to `pos` where `keep`, into `budget`
    slots filled with its entry of `fills`; the rest go to drop slots past
    the budget, one each (millions of stores to one address serialise)."""
    n = keep.shape[0]
    target = torch.where(keep, pos, budget + torch.arange(n, device=keep.device))
    out = []
    for v, fill in zip(values, fills):
        buf = torch.full((budget + n,), fill, dtype=v.dtype, device=v.device)
        out.append(buf.scatter_(0, target, v)[:budget])
    return out


def generate_samples(
    tmin: torch.Tensor,
    tmax: torch.Tensor,
    ray_valid: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    step_size: float,
    samples_per_ray: int,
    budget: int,
    grids: Optional[torch.Tensor] = None,
    grid_ids: Optional[torch.Tensor] = None,
) -> SampleSet:
    """Per-ray lattice samples, compacted into a (budget,)-slot buffer.

    A ray keeps ``min(floor((tmax − tmin)/step), samples_per_ray)`` lattice
    points (`ray_sampler.cu:283-285`); with `grids`/`grid_ids` each is also
    tested against the corner-dilated occupancy grid (`ray_sampler.cu:
    183-189`), else only the [tmin, tmax] range applies.
    """
    j = torch.arange(samples_per_ray, dtype=torch.float32, device=tmin.device)[None, :]
    t = tmin[:, None] + j * step_size
    counts = torch.floor((tmax - tmin) / step_size).to(torch.int32)
    counts = torch.where(ray_valid, torch.clamp(counts, max=samples_per_ray), 0)
    valid = j < counts[:, None].float()
    if grids is not None:
        pts = origins[:, None, :] + dirs[:, None, :] * t[..., None] + 0.5
        valid = valid & sample_occupancy(grids, grid_ids[:, None], pts)
    return compact_samples(t, valid, budget)


def compact_samples(t: torch.Tensor, valid: torch.Tensor, budget: int) -> SampleSet:
    """Compact an (R, samples_per_ray) candidate lattice into (budget,) slots,
    ray-major then ascending t (the row-major flatten)."""
    num_rays, samples_per_ray = t.shape
    flat_ray = torch.arange(num_rays, dtype=torch.int32, device=t.device)[:, None].expand(-1, samples_per_ray).reshape(-1)
    incl = torch.cumsum(valid.reshape(-1).int(), 0)
    pos = incl - 1
    keep = valid.reshape(-1) & (pos < budget)
    out_t, out_ray = _compact((t.reshape(-1), flat_ray), keep, pos, budget, (0.0, num_rays))
    # A ray is included iff its valid samples, and all before them, fit.
    ray_included = incl.reshape(num_rays, samples_per_ray)[:, -1] <= budget
    num_valid = torch.clamp(valid.sum(), max=budget).int()
    valid_slots = torch.arange(budget, device=t.device) < num_valid
    return SampleSet(out_t, out_ray, valid_slots, ray_included, num_valid)


def compact_flat_samples(sample_set: SampleSet, new_valid: torch.Tensor, budget: int) -> SampleSet:
    """Re-compact a flat SampleSet after a further prune (the visibility
    prune, `humanrf/volume_rendering.py:83-84`); order is kept. A ray stays
    included iff none of its surviving samples fell past the budget (a
    max-scatter over the rays)."""
    num_rays = sample_set.ray_included.shape[0]
    flat_valid = new_valid & sample_set.valid
    incl = torch.cumsum(flat_valid.int(), 0)
    pos = incl - 1
    keep = flat_valid & (pos < budget)
    out_t, out_ray = _compact((sample_set.t, sample_set.ray), keep, pos, budget, (0.0, num_rays))
    overflowed = (flat_valid & (pos >= budget)).int()
    # Empty slots (ray == num_rays) go to places of their own past the rays.
    n = overflowed.shape[0]
    ray = sample_set.ray.long()
    target = torch.where(ray < num_rays, ray, num_rays + torch.arange(n, device=ray.device))
    ray_overflow = torch.zeros(num_rays + n, dtype=torch.int32, device=overflowed.device).scatter_reduce_(
        0, target, overflowed, "amax"
    )[:num_rays]
    ray_included = sample_set.ray_included & (ray_overflow == 0)
    num_valid = torch.clamp(flat_valid.sum(), max=budget).int()
    valid_slots = torch.arange(budget, device=out_t.device) < num_valid
    return SampleSet(out_t, out_ray, valid_slots, ray_included, num_valid)
