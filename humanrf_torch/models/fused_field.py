"""The 4D decomposition on the CUDA `fused_interp` kernel.

Counterpart of `humanrf_tpu/models/fused_field.py`. Every table lookup (all
4·L grid level-pairs, then the four 1-D vectors) is one `fused_interp` call,
so a field query launches the forward kernel twice, and its backward the
backward kernel twice. Layouts follow the JAX package:
samples on the last axis, (P, C, N) corner indices/weights, (P, F, N)
features, one (D, N) → (N, D) transpose at the end.

Bit-exactness with the JAX package: the grid scale is applied in float32 with
the scale as a Python float (`x * scale + 0.5`), so `floor` picks the same
cell, and the spatial hash multiplies in int64 and wraps to uint32 before the
XOR, which reproduces JAX's uint32 arithmetic bit for bit.
"""
from __future__ import annotations

from typing import Mapping

import torch

from humanrf_torch.models.hash_encoding import _CORNER_BITS, _HASH_PRIMES
from humanrf_torch.ops.fused_interp import fused_interp

# Grid name → which of (x, y, z, t) it consumes; partner vector axis per grid
# (tensor_composition.cu:49-52): out = f_xyz⊙v_t + f_xyt⊙v_z + f_yzt⊙v_x + f_xzt⊙v_y.
_GRID_AXES = (
    ("xyz", (0, 1, 2)),
    ("xyt", (0, 1, 3)),
    ("yzt", (1, 2, 3)),
    ("xzt", (0, 2, 3)),
)
_PARTNER_VECTOR = (3, 2, 0, 1)

_UINT32_MASK = 0xFFFFFFFF


def _grid_corner_idx_w(pts: torch.Tensor, level_scales, level_resolutions, table_size: int):
    """pts (N, 3) in [0,1] → idx (L, 8, N) int32, w (L, 8, N) f32."""
    x = pts.clamp(0.0, 1.0)
    idx_levels, w_levels = [], []
    for level in range(len(level_scales)):
        scaled = x * float(level_scales[level]) + 0.5
        floor = torch.floor(scaled)
        frac = scaled - floor
        base = floor.long()
        res = int(level_resolutions[level])
        dense = res**3 <= table_size

        idx_c, w_c = [], []
        for bits in _CORNER_BITS:
            c = [base[:, d] + bits[d] for d in range(3)]
            if dense:
                idx = c[0] + c[1] * res + c[2] * (res * res)
            else:
                h = (
                    ((c[0] * _HASH_PRIMES[0]) & _UINT32_MASK)
                    ^ ((c[1] * _HASH_PRIMES[1]) & _UINT32_MASK)
                    ^ ((c[2] * _HASH_PRIMES[2]) & _UINT32_MASK)
                )
                idx = h % table_size
            w = torch.ones_like(frac[:, 0])
            for d in range(3):
                w = w * (frac[:, d] if bits[d] else (1.0 - frac[:, d]))
            idx_c.append(idx.int())
            w_c.append(w)
        idx_levels.append(torch.stack(idx_c))  # (8, N)
        w_levels.append(torch.stack(w_c))
    return torch.stack(idx_levels), torch.stack(w_levels)  # (L, 8, N)


def _vector_idx_w(coords4: torch.Tensor, resolution: int):
    """coords4 (N, 4) in [0,1] → idx (4, 2, N) int32, w (4, 2, N) f32.

    align_corners=True linear sampling: the two corner indices are clamped to
    [0, R-1]."""
    coord = coords4 * resolution - 0.5  # (N, 4)
    base = torch.floor(coord)
    frac = coord - base
    i0 = base.clamp(0, resolution - 1).int()
    i1 = (base + 1).clamp(0, resolution - 1).int()
    idx = torch.stack([i0.T, i1.T], dim=1)  # (4, 2, N)
    w = torch.stack([(1.0 - frac).T, frac.T], dim=1)
    return idx.contiguous(), w.contiguous()


def apply_decomposition4d_fused(params: Mapping[str, torch.Tensor], xyz, times, cfg) -> torch.Tensor:
    """xyz (N, 3) in [0,1]; times (N, 1) in [0,1] → (N, L·F) fp32 features."""
    grid_cfg = cfg.grid
    T = grid_cfg.table_size
    n = xyz.shape[0]
    L, F = grid_cfg.n_levels, grid_cfg.n_features_per_level
    scales = grid_cfg.level_scales()
    resolutions = grid_cfg.level_resolutions()
    xyzt = torch.cat([xyz, times], dim=-1)  # (N, 4)

    idx_all, w_all = [], []
    for _, axes in _GRID_AXES:
        idx_g, w_g = _grid_corner_idx_w(xyzt[:, list(axes)], scales, resolutions, T)
        idx_all.append(idx_g)
        w_all.append(w_g)
    idx_all = torch.cat(idx_all, dim=0)  # (4L, 8, N)
    w_all = torch.cat(w_all, dim=0)
    # A dense level's far corner can index past the table (res³ ≤ T <
    # res³ + res² + res); fused_interp gives it no weight, as the TPU kernel does.
    tables = torch.cat([params[name] for name, _ in _GRID_AXES], dim=0)  # (4L, F, T)

    feats = fused_interp(tables.contiguous(), idx_all.contiguous(), w_all.contiguous())  # (4L, F, N)
    f = feats.reshape(4, L * F, n)

    vectors = params["vectors"]  # (4, D, R) with D == L*F
    idx_v, w_v = _vector_idx_w(xyzt.clamp(0.0, 1.0), vectors.shape[-1])
    v = fused_interp(vectors.contiguous(), idx_v, w_v)  # (4, D, N)

    out = f[0] * v[_PARTNER_VECTOR[0]]
    for g in range(1, 4):
        out = out + f[g] * v[_PARTNER_VECTOR[g]]
    return out.T
