"""Importance resampling along rays (proposal sampling).

Counterpart of `humanrf_tpu/ops/resample.py`: coarse stratified bins, a
per-ray piecewise-constant PDF from the proposal weights, a stratified
inverse-CDF draw of the render intervals, and the interlevel (distillation)
loss that teaches the proposal to bound the fine weights. Each draw takes
optional stratified offsets `u`; without them it takes the render path's
deterministic draw (bin centres, strata midpoints).

Where the JAX package picks one bin per row by a one-hot select-and-sum (a
TPU has no fast gather), the port gathers: the same value, and the same
gradient, which reaches only the picked element.
"""
from __future__ import annotations

from typing import Optional

import torch


def stratified_bins(tmin: torch.Tensor, tmax: torch.Tensor, num_bins: int, u: Optional[torch.Tensor] = None):
    """tmin/tmax (R,) → (t (R, K), dt (R, K), edges (R, K+1)): the sample of
    bin k at offset u[:, k] ∈ [0, 1) within it (0.5, the centre, when None)."""
    span = torch.clamp(tmax - tmin, min=1e-8)[:, None]  # (R, 1)
    k = torch.arange(num_bins + 1, dtype=torch.float32, device=tmin.device)[None, :]
    edges = tmin[:, None] + span * (k / num_bins)
    t = edges[:, :-1] + (span / num_bins) * (0.5 if u is None else u)
    dt = (span / num_bins).expand(tmin.shape[0], num_bins)
    return t, dt, edges


def weights_to_cdf(weights: torch.Tensor, uniform_bonus: float = 1e-2) -> torch.Tensor:
    """(R, K) non-negative weights → (R, K+1) normalized CDF with 0/1 endpoints,
    with a uniform floor of `uniform_bonus` mixed in."""
    w = torch.clamp(weights, min=0.0) + uniform_bonus / weights.shape[-1]
    cum = torch.cumsum(w, dim=-1)
    cdf = cum / torch.clamp(cum[:, -1:], min=1e-12)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)


def _bin_of(boundaries: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """boundaries (R, K+1), t (R, S) → (R, S) index of the bin each t falls in:
    the count of boundaries <= t, minus one, clamped to [0, K-1]."""
    kp1 = boundaries.shape[1]
    return torch.clamp((boundaries[:, None, :] <= t[:, :, None]).sum(dim=-1) - 1, 0, kp1 - 2)


def sample_intervals(
    edges: torch.Tensor, cdf: torch.Tensor, num_samples: int, u: Optional[torch.Tensor] = None, return_edges: bool = False
):
    """Inverse-CDF draw of `num_samples` intervals per ray.

    edges, cdf: (R, K+1); u: (R, S+1) stratified offsets of the interval edges
    in [0, 1) (the strata's midpoints when None) → (t_mid (R, S), dt (R, S))
    [, t_edges (R, S+1)].
    """
    s = num_samples
    j = torch.arange(s + 1, dtype=torch.float32, device=edges.device)[None, :]
    strata = j if u is None else j + u - 0.5
    pos = torch.clamp(strata / s, 1e-6, 1.0 - 1e-6)  # (R or 1, S+1)
    pos = pos.expand(edges.shape[0], s + 1)

    bin_idx = _bin_of(cdf, pos)
    c0 = torch.gather(cdf[:, :-1], 1, bin_idx)
    c1 = torch.gather(cdf[:, 1:], 1, bin_idx)
    e0 = torch.gather(edges[:, :-1], 1, bin_idx)
    e1 = torch.gather(edges[:, 1:], 1, bin_idx)
    frac = (pos - c0) / torch.clamp(c1 - c0, min=1e-12)
    t_edges = e0 + frac * (e1 - e0)  # (R, S+1), non-decreasing

    t_mid = 0.5 * (t_edges[:, 1:] + t_edges[:, :-1])
    dt = t_edges[:, 1:] - t_edges[:, :-1]
    if return_edges:
        return t_mid, dt, t_edges
    return t_mid, dt


def histogram_outer_mass(edges: torch.Tensor, weights: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Proposal mass over each query interval, through the proposal's
    piecewise-linear cumulative mass.

    edges (R, K+1), weights (R, K) (not normalized), t0/t1 (R, S) → (R, S).
    """
    cum = torch.cat([torch.zeros_like(weights[:, :1]), torch.cumsum(weights, dim=-1)], dim=-1)

    def cum_at(t):
        idx = _bin_of(edges, t)
        e0, e1 = torch.gather(edges[:, :-1], 1, idx), torch.gather(edges[:, 1:], 1, idx)
        c0, c1 = torch.gather(cum[:, :-1], 1, idx), torch.gather(cum[:, 1:], 1, idx)
        frac = torch.clamp((t - e0) / torch.clamp(e1 - e0, min=1e-12), 0.0, 1.0)
        below = c0 + frac * (c1 - c0)
        below = torch.where(t <= edges[:, :1], 0.0, below)  # clamp outside the range
        return torch.where(t >= edges[:, -1:], cum[:, -1:], below)

    diff = cum_at(t1) - cum_at(t0)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does.
    return torch.maximum(diff, torch.zeros_like(diff))


def proposal_distillation_per_ray(
    prop_edges: torch.Tensor,
    prop_weights: torch.Tensor,
    fine_t0: torch.Tensor,
    fine_t1: torch.Tensor,
    fine_weights: torch.Tensor,
) -> torch.Tensor:
    """mip-NeRF 360 interlevel loss per ray (R,): the proposal histogram must
    upper-bound the detached fine weights on every fine interval,

        L_ray = Σ_samples relu(w_f − P)² / (w_f + 1e-7).

    Gradients flow only into `prop_weights`; callers mask and average.
    """
    w_f = fine_weights.detach()
    bound = histogram_outer_mass(prop_edges, prop_weights, fine_t0, fine_t1)
    excess = w_f - bound
    excess = torch.maximum(excess, torch.zeros_like(excess))
    return (excess**2 / (w_f + 1e-7)).sum(dim=-1)
