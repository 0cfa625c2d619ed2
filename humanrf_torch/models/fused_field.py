"""The 4D decomposition on the CUDA field query kernels.

Counterpart of `humanrf_tpu/models/fused_field.py`. A field query is one
`field_query` call (`ops/field_interp.py`) over every segment's tables: on
the card one forward kernel launch, which computes each sample's corners,
the four grids' and vectors' lookups, their products and sum, and writes
the (N, L·F) features, and one backward launch; no (4, L·F, N) lookup
tensor exists. The skip inputs `n_valid` and `seg` route and skip samples
inside the kernels (see `ops/field_interp.py`). The plain version,
`field_query_plain`, is the same query in PyTorch: per segment a grid and a
vector `field_interp` call, the sum over segments and `compose`; CPU
tensors take it, and it is the card's reference for the kernels.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from humanrf_torch.ops.field_interp import (  # noqa: F401  (corner math re-exported for the tests)
    _GRID_AXES,
    SegmentField,
    _grid_corner_idx_w,
    _vector_idx_w,
    field_query,
    grid_spec,
)


def segment_field(params: Mapping[str, torch.Tensor], cfg, tables: Optional[torch.Tensor] = None) -> SegmentField:
    """One segment's part of a field query from its parameters: the four
    grids `xyz`, `xyt`, `yzt`, `xzt`, or `tables`, their (4L, F, T) stack
    where the caller holds it (the FSDP step gathers it once per step), and
    `vectors`."""
    grids = (tables,) if tables is not None else tuple(params[name] for name, _ in _GRID_AXES)
    return SegmentField(grids, params["vectors"], grid_spec(cfg.grid))


def apply_decomposition4d_fused(params: Mapping[str, torch.Tensor], xyz, times, cfg,
                                tables: Optional[torch.Tensor] = None, n_valid: Optional[torch.Tensor] = None,
                                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xyz (N, 3) in [0,1]; times (N, 1) in [0,1] → (N, L·F) fp32 features
    of one segment (`field_query`; samples whose `seg` is not 0, or past
    `n_valid`, get zeros)."""
    xyzt = torch.cat([xyz, times], dim=-1).detach()  # positions get no gradient, as in JAX
    return field_query([segment_field(params, cfg, tables)], xyzt, n_valid, seg)
