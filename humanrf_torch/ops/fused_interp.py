"""The interpolating lookup's contract in plain PyTorch:
`out[p, f, n] = Σ_c w[p, c, n] · tables[p, f, idx[p, c, n]]`.

Counterpart of `humanrf_tpu/ops/fused_interp.py`'s oracle, forward and
backward, on given corner indices and weights (idx, w). The TPU kernels
there build bf16 one-hot rows in VMEM and contract them on the MXU; here the
contract is computed directly in fp32: the forward gathers and sums, the
backward scatter-adds `g · w` into the tables. As with the one-hot rows, a
corner whose index lies outside [0, T) contributes nothing and gets no
gradient. `ops/field_interp.py` computes the corners and calls these; the
CPU tests hold them to the JAX package's oracle and Pallas kernel.
"""
from __future__ import annotations

import torch


def _in_table(idx: torch.Tensor, w: torch.Tensor, table_size: int):
    """Out-of-table corners → index 0 with weight 0."""
    in_table = (idx >= 0) & (idx < table_size)
    return torch.where(in_table, idx, 0).long(), torch.where(in_table, w, 0.0)


def fused_interp_plain(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gather plus weighted sum in PyTorch (the contract, fp32), summed over
    c = 0..C-1 in order, as the field query's kernel sums a lookup; one
    (P, F, N) gather per corner."""
    P, F, T = tables.shape
    _, C, N = idx.shape
    idx, w = _in_table(idx, w, T)
    out = torch.zeros((P, F, N), dtype=torch.float32, device=tables.device)
    for c in range(C):
        gathered = torch.gather(tables, 2, idx[:, c, None, :].expand(P, F, N))
        out = out + gathered * w[:, c, None, :]
    return out


def fused_interp_bwd_plain(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, table_size: int) -> torch.Tensor:
    """The backward's contract in PyTorch: `scatter_add_` of g·w into a zeroed
    (P, F, T) tensor of g's type (fp32 through `field_interp`; fp64 sums
    the card checks' reference), one corner at a time. An out-of-table corner adds 0 at index
    0, which leaves the sum as it is."""
    P, F, N = g.shape
    idx, w = _in_table(idx, w, table_size)
    dtab = torch.zeros((P, F, table_size), dtype=g.dtype, device=g.device)
    for c in range(idx.shape[1]):
        dtab.scatter_add_(2, idx[:, c, None, :].expand(P, F, N), g * w[:, c, None, :])
    return dtab
