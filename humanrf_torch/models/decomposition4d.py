"""HumanRF's 4D feature-grid decomposition: configuration and parameter module.

Counterpart of `humanrf_tpu/models/decomposition4d.py`. The JAX package has
three lookup backends (gather, onehot, fused) because a TPU has no fast
gather; the port has one, `models/fused_field.py::apply_decomposition4d_fused`
on the CUDA `field_interp` kernels, which take any table size.

    out = f_xyz ⊙ v_t + f_xyt ⊙ v_z + f_yzt ⊙ v_x + f_xzt ⊙ v_y
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from humanrf_torch.models.fused_field import _GRID_AXES, apply_decomposition4d_fused
from humanrf_torch.models.hash_encoding import HashGridConfig
from humanrf_torch.models.mlp import normal

GRID_NAMES = tuple(name for name, _ in _GRID_AXES)


@dataclass(frozen=True)
class Decomposition4DConfig:
    grid: HashGridConfig = HashGridConfig()
    vectors_finest_resolution: int = 2048

    @property
    def feature_dim(self) -> int:
        return self.grid.feature_dim


class Decomposition4D(nn.Module):
    """One segment's parameters in the JAX layouts: four hash tables
    `xyz`, `xyt`, `yzt`, `xzt` of shape (L, F, T) and `vectors` (4, D, R).

    Under FSDP (`humanrf_torch/parallel/fsdp.py`) the four tables are this
    rank's (L, F, T/D) shards, and a query passes the (4L, F, T) stack
    gathered from every rank as `tables`."""

    def __init__(self, cfg: Decomposition4DConfig, device=None):
        super().__init__()
        self.cfg = cfg
        g = cfg.grid
        for name in GRID_NAMES:
            shape = (g.n_levels, g.n_features_per_level, g.table_size)
            self.register_parameter(name, nn.Parameter(torch.zeros(shape, device=device)))
        self.vectors = nn.Parameter(
            torch.zeros((4, cfg.feature_dim, cfg.vectors_finest_resolution), device=device)
        )

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Hash tables U[-1e-4, 1e-4] (tcnn's default), vectors 0.1·N(0, 1),
        as `humanrf_tpu/models/decomposition4d.py::init_decomposition4d`."""
        for name in GRID_NAMES:
            table = getattr(self, name)
            u = torch.rand(table.shape, generator=generator, device=generator.device)
            table.copy_(u * 2e-4 - 1e-4)
        self.vectors.copy_(0.1 * normal(self.vectors.shape, generator))

    def forward(self, xyz: torch.Tensor, times: torch.Tensor, tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = {name: getattr(self, name) for name in (*GRID_NAMES, "vectors")}
        return apply_decomposition4d_fused(params, xyz, times, self.cfg, tables)
