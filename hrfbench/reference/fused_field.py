"""The 4D decomposition's table lookups in plain PyTorch, differentiable by autograd.

The contract of the port's `field_interp` kernels: per sample, the corner
indices and weights of every grid level-pair (8 corners, Instant-NGP's
spatial hash or dense indexing) and of every 1-D vector (2 clamped taps),
then `out[p, f, n] = Σ_c w[p, c, n] · tables[p, f, idx[p, c, n]]`, with
corners outside the table adding nothing. Autograd's gather backward is the
scatter-add into the tables. Skipped samples (past `n_valid`, or of another
segment) read zeros and add nothing to the gradient.

`round_tables` reads the tables through bfloat16: the lower precision of the
correctness control, never of the reference itself.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from hrfbench.reference.hash_encoding import _CORNER_BITS, _HASH_PRIMES

# Grid name → which of (x, y, z, t) it consumes; the partner vector of each grid:
# out = f_xyz⊙v_t + f_xyt⊙v_z + f_yzt⊙v_x + f_xzt⊙v_y.
_GRID_AXES = (
    ("xyz", (0, 1, 2)),
    ("xyt", (0, 1, 3)),
    ("yzt", (1, 2, 3)),
    ("xzt", (0, 2, 3)),
)
_PARTNER_VECTOR = (3, 2, 0, 1)
_UINT32_MASK = 0xFFFFFFFF


def _grid_corner_idx_w(pts: torch.Tensor, level_scales, level_resolutions, table_size: int):
    """pts (N, 3) in [0,1] → idx (L, 8, N) int64, w (L, 8, N) f32."""
    x = pts.clamp(0.0, 1.0)
    idx_levels, w_levels = [], []
    for level in range(len(level_scales)):
        scaled = x * float(level_scales[level]) + 0.5
        floor = torch.floor(scaled)
        frac = scaled - floor
        base = floor.long()
        res = int(level_resolutions[level])
        is_dense = res**3 <= table_size
        idx_c, w_c = [], []
        for bits in _CORNER_BITS:
            c = [base[:, d] + bits[d] for d in range(3)]
            if is_dense:
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
            idx_c.append(idx)
            w_c.append(w)
        idx_levels.append(torch.stack(idx_c))
        w_levels.append(torch.stack(w_c))
    return torch.stack(idx_levels), torch.stack(w_levels)


def _vector_idx_w(coords4: torch.Tensor, resolution: int):
    """coords4 (N, 4) in [0,1] → idx (4, 2, N) int64, w (4, 2, N) f32
    (align_corners=True linear taps, clamped to [0, R-1])."""
    coord = coords4.clamp(0.0, 1.0) * resolution - 0.5
    base = torch.floor(coord)
    frac = coord - base
    i0 = base.clamp(0, resolution - 1).long()
    i1 = (base + 1).clamp(0, resolution - 1).long()
    return torch.stack([i0.T, i1.T], dim=1), torch.stack([(1.0 - frac).T, frac.T], dim=1)


def interp(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, live: Optional[torch.Tensor]) -> torch.Tensor:
    """tables (P, F, T), idx/w (P, C, N) → (P, F, N), summed over the corners in order."""
    P, F, T = tables.shape
    _, C, N = idx.shape
    in_table = (idx >= 0) & (idx < T)
    idx = torch.where(in_table, idx, 0)
    w = torch.where(in_table, w, 0.0)
    if live is not None:
        w = torch.where(live, w, 0.0)
    out = None
    for c in range(C):
        term = torch.gather(tables, 2, idx[:, c, None, :].expand(P, F, N)) * w[:, c, None, :]
        out = term if out is None else out + term
    return out


def _log_call(log: list, kind: str, idx: torch.Tensor, tables: torch.Tensor, live: Optional[torch.Tensor]) -> None:
    """Append what one lookup call serves: its samples and the (pair, row)
    entries of the table they touch (the inputs of `hrfbench/counts/`)."""
    P, F, T = tables.shape
    grad = torch.is_grad_enabled() and tables.requires_grad
    if live is not None:
        idx = idx[:, :, live]
    n = idx.shape[2]
    with torch.no_grad():  # corners outside the table add nothing and touch no row
        flat = torch.arange(P, device=idx.device)[:, None, None] * T + idx
        rows = flat[(idx >= 0) & (idx < T)].unique().numel()
    log.append({"kind": kind, "n": n, "P": P, "C": idx.shape[1], "F": F, "T": T, "rows": rows,
                "grad": grad})


def field_lookups(params: Mapping[str, torch.Tensor], xyz, times, cfg, tables=None, n_valid=None, seg=None, s: int = 0,
                  round_tables: bool = False, log: Optional[list] = None):
    """xyz (N, 3) in [0,1]; times (N, 1) in [0,1] → the grids' and vectors'
    lookups, each (4, L·F, N) fp32. With a `log`, each of the two calls
    appends what it serves (`_log_call`)."""
    grid_cfg = cfg.grid
    n = xyz.shape[0]
    L, F = grid_cfg.n_levels, grid_cfg.n_features_per_level
    xyzt = torch.cat([xyz, times], dim=-1).detach()
    live = None
    if n_valid is not None:
        live = torch.arange(n, device=xyz.device) < n_valid.reshape(())
    if seg is not None:
        live = seg == s if live is None else live & (seg == s)
    if tables is None:
        tables = torch.cat([params[name] for name, _ in _GRID_AXES], dim=0)
    vectors = params["vectors"]
    if round_tables:
        tables, vectors = tables.to(torch.bfloat16).float(), vectors.to(torch.bfloat16).float()
    scales, resolutions = grid_cfg.level_scales(), grid_cfg.level_resolutions()
    idx, w = [], []
    for _, axes in _GRID_AXES:
        i, wt = _grid_corner_idx_w(xyzt[:, list(axes)], scales, resolutions, grid_cfg.table_size)
        idx.append(i)
        w.append(wt)
    idx, w = torch.cat(idx), torch.cat(w)
    v_idx, v_w = _vector_idx_w(xyzt, vectors.shape[2])
    if log is not None:
        _log_call(log, "grid", idx, tables, live)
        _log_call(log, "vector", v_idx, vectors, live)
    feats = interp(tables, idx, w, live)
    v = interp(vectors, v_idx, v_w, live)
    return feats.reshape(4, L * F, n), v


def compose(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(4, D, N) lookups → (N, D) features."""
    out = f[0] * v[_PARTNER_VECTOR[0]]
    for g in range(1, 4):
        out = out + f[g] * v[_PARTNER_VECTOR[g]]
    return out.T
