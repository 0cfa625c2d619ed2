"""The 4D decomposition on the CUDA `field_interp` kernels.

Counterpart of `humanrf_tpu/models/fused_field.py`. A field query is two
`field_interp` calls: the grid mode over all 4·L grid level-pairs, then the
vector mode over the four 1-D vectors. The kernels compute each sample's
corners themselves (the corner math lives in `ops/field_interp.py`, with
the plain versions), so a field query launches the forward kernel twice and
its backward the backward kernel twice. Layouts follow the JAX package:
samples on the last axis, (P, F, N) features, one (D, N) → (N, D) transpose
at the end (`compose`). The skip inputs `n_valid` and `seg`/`s` go to both
calls (`field_lookups`; see `ops/field_interp.py`): a skipped sample's
lookups are exact zeros, so a multi-segment model sums its segments'
lookups and composes once (`models/humanrf.py::features`).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from humanrf_torch.ops.field_interp import (  # noqa: F401  (corner math re-exported for the tests)
    _GRID_AXES,
    _PARTNER_VECTOR,
    VECTOR_SPEC,
    _grid_corner_idx_w,
    _vector_idx_w,
    field_interp,
    grid_spec,
)


def field_lookups(params: Mapping[str, torch.Tensor], xyz, times, cfg, tables: Optional[torch.Tensor] = None,
                  n_valid: Optional[torch.Tensor] = None, seg: Optional[torch.Tensor] = None, s: int = 0):
    """xyz (N, 3) in [0,1]; times (N, 1) in [0,1] → the grids' and the
    vectors' lookups, each (4, L·F, N) fp32. `tables` is the (4L, F, T) stack
    of the four grids when the caller has it (the FSDP step gathers it once
    per step); else it is concatenated from `params`. Samples past
    `n_valid`, or whose `seg` is not `s`, look up zeros."""
    grid_cfg = cfg.grid
    n = xyz.shape[0]
    L, F = grid_cfg.n_levels, grid_cfg.n_features_per_level
    xyzt = torch.cat([xyz, times], dim=-1).detach()  # (N, 4); positions get no gradient, as in JAX

    # A dense level's far corner can index past the table (res³ ≤ T <
    # res³ + res² + res); field_interp gives it no weight, as the TPU kernel does.
    if tables is None:
        tables = torch.cat([params[name] for name, _ in _GRID_AXES], dim=0)  # (4L, F, T)
    feats = field_interp(tables, xyzt, grid_spec(grid_cfg), n_valid, seg, s)  # (4L, F, N)
    v = field_interp(params["vectors"], xyzt, VECTOR_SPEC, n_valid, seg, s)  # (4, D, N), D == L·F
    return feats.reshape(4, L * F, n), v


def compose(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The grids' and vectors' lookups (4, D, N) → (N, D) features,
    f_xyz⊙v_t + f_xyt⊙v_z + f_yzt⊙v_x + f_xzt⊙v_y."""
    out = f[0] * v[_PARTNER_VECTOR[0]]
    for g in range(1, 4):
        out = out + f[g] * v[_PARTNER_VECTOR[g]]
    return out.T


def apply_decomposition4d_fused(params: Mapping[str, torch.Tensor], xyz, times, cfg,
                                tables: Optional[torch.Tensor] = None, n_valid: Optional[torch.Tensor] = None,
                                seg: Optional[torch.Tensor] = None, s: int = 0) -> torch.Tensor:
    """xyz (N, 3) in [0,1]; times (N, 1) in [0,1] → (N, L·F) fp32 features
    (`field_lookups`, then `compose`)."""
    return compose(*field_lookups(params, xyz, times, cfg, tables, n_valid, seg, s))
