"""Importance resampling along rays (proposal sampling).

Counterpart of `humanrf_tpu/ops/resample.py` (render-path functions): coarse
stratified bins, a per-ray piecewise-constant PDF from the proposal weights,
and a stratified inverse-CDF draw of the render intervals.
"""
from __future__ import annotations

import torch


def stratified_bins(tmin: torch.Tensor, tmax: torch.Tensor, num_bins: int):
    """tmin/tmax (R,) → (t_mid (R, K), dt (R, K), edges (R, K+1)), with the
    samples at the bin centres (the render path's deterministic draw)."""
    span = torch.clamp(tmax - tmin, min=1e-8)[:, None]  # (R, 1)
    k = torch.arange(num_bins + 1, dtype=torch.float32, device=tmin.device)[None, :]
    edges = tmin[:, None] + span * (k / num_bins)
    t = edges[:, :-1] + (span / num_bins) * 0.5
    dt = (span / num_bins).expand(tmin.shape[0], num_bins)
    return t, dt, edges


def weights_to_cdf(weights: torch.Tensor, uniform_bonus: float = 1e-2) -> torch.Tensor:
    """(R, K) non-negative weights → (R, K+1) normalized CDF with 0/1 endpoints,
    with a uniform floor of `uniform_bonus` mixed in."""
    w = torch.clamp(weights, min=0.0) + uniform_bonus / weights.shape[-1]
    cum = torch.cumsum(w, dim=-1)
    cdf = cum / torch.clamp(cum[:, -1:], min=1e-12)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)


def sample_intervals(edges: torch.Tensor, cdf: torch.Tensor, num_samples: int, return_edges: bool = False):
    """Inverse-CDF draw of `num_samples` intervals per ray, the interval
    edges at the strata's midpoints (the render path's deterministic draw).

    edges, cdf: (R, K+1) → (t_mid (R, S), dt (R, S)) [, t_edges (R, S+1)].
    """
    kp1 = edges.shape[1]
    s = num_samples
    j = torch.arange(s + 1, dtype=torch.float32, device=edges.device)[None, :]
    pos = torch.clamp(j / s, 1e-6, 1.0 - 1e-6)  # (1, S+1)

    # Count of CDF entries <= pos, minus one: the bin each edge falls in.
    bin_idx = torch.clamp((cdf[:, None, :] <= pos[:, :, None]).sum(dim=-1) - 1, 0, kp1 - 2)
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
