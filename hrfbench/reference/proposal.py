"""CP-factorized 4D proposal density field (the importance sampler's cheap field).

Counterpart of `humanrf_tpu/models/proposal.py`:

    sigma(x, y, z, t) = truncated_exp( Σ_r u_r(x) · v_r(y) · w_r(z) · s_r(t) ) · scale

The JAX package computes each 1-D lerp as a bf16 two-hot row times the bf16
factor matrix with fp32 accumulation. The port computes the same two taps by
index: lerp weights and factors rounded to bf16, products and their sum in
fp32. Where both taps clamp to the same index, the two-hot row holds their
bf16 sum in one slot, and so does the port.

The taps are row gathers by `F.embedding`, not `factors[idx]`: a training
batch sends ~500k samples into 128 rows, and the backward of advanced
indexing on CUDA (`indexing_backward_kernel`) sums duplicate rows one after
another, ~0.37 s a step at the flagship shapes on an H100; the embedding
backward sorts the indices and reduces each row's segment in parallel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hrfbench.reference.activation import truncated_exp
from hrfbench.reference.mlp import normal


@dataclass(frozen=True)
class ProposalFieldConfig:
    resolution: int = 128
    rank: int = 16
    density_scale: float = 1.0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def apply_proposal_field(
    params: Mapping[str, torch.Tensor], coords: torch.Tensor, cfg: ProposalFieldConfig,
    seg: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """coords: (N, 4) [x, y, z, t] in [0, 1] → density (N,) fp32.

    align_corners=True linear sampling of each axis factor. `params
    ["factors"]` is one segment's (4, res, rank); with `seg`, the (N,) int32
    segment of each sample, it is every segment's stacked, (S, 4, res,
    rank), and each sample reads its own segment's rows in the same gathers
    (a sample of no segment, seg < 0, reads density 0): a multi-segment
    model's routing with static shapes, each sample's numbers those of its
    segment's field alone.
    """
    res = cfg.resolution
    factors = _bf16(params["factors"])
    if seg is None:
        factors, first_row = factors[None], 0
    else:
        first_row = seg.clamp(min=0).long() * res  # the sample's segment's first row in (S·res, rank)

    rank_prod = None
    for axis in range(4):
        coord = coords[:, axis] * res - 0.5
        base = torch.floor(coord)
        frac = coord - base
        i0 = base.clamp(0, res - 1).long()
        i1 = (base + 1).clamp(0, res - 1).long()
        w0, w1 = _bf16(1.0 - frac), _bf16(frac)
        same = i0 == i1
        w0 = torch.where(same, _bf16(w0 + w1), w0)
        w1 = torch.where(same, torch.zeros_like(w1), w1)
        f = factors[:, axis].reshape(-1, factors.shape[-1])  # (S·res, rank)
        vals = w0[:, None] * F.embedding(first_row + i0, f) + w1[:, None] * F.embedding(first_row + i1, f)  # (N, rank)
        rank_prod = vals if rank_prod is None else rank_prod * vals

    raw = rank_prod.sum(dim=-1)
    sigma = truncated_exp(raw) * cfg.density_scale
    return sigma if seg is None else torch.where(seg >= 0, sigma, 0.0)


class ProposalField(nn.Module):
    """One segment's factors (4 axes, resolution, rank), the JAX layout."""

    def __init__(self, cfg: ProposalFieldConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.factors = nn.Parameter(torch.zeros((4, cfg.resolution, cfg.rank), device=device))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """0.3·N(0, 1), as `humanrf_tpu/models/proposal.py::init_proposal_field`."""
        self.factors.copy_(0.3 * normal(self.factors.shape, generator))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return apply_proposal_field({"factors": self.factors}, coords, self.cfg)
