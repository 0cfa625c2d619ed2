"""The field's table lookups with their corner math: `field_interp(tables, xyzt, spec)`.

Counterpart of what `humanrf_tpu/models/fused_field.py` does around each
`fused_interp` call: the corner indices and weights of every sample
(`_grid_corner_idx_w`, `_vector_idx_w`), then the interpolating lookup
`out[p, f, n] = Σ_c w[p, c, n] · tables[p, f, idx[p, c, n]]`. On the card
the hand-written CUDA kernels of `humanrf_torch/csrc/field_interp.cu`
compute the corners in registers from the (N, 4) sample coordinates, so no
(P, C, N) index or weight tensor exists; their source note says what bounds
them and how the design answers.

Two modes, described by a `FieldSpec` passed to the kernels by value:

- grid (`grid_spec(HashGridConfig)`): tables (4L, F, T), pair g·L + l is
  grid g of `_GRID_AXES` at level l, 8 corners each;
- vector (`VECTOR_SPEC`): tables (4, D, R), pair p reads coordinate p of
  `xyzt`, 2 clamped taps.

`field_interp` is differentiable in `tables` only, as the JAX `custom_vjp`
is: `xyzt` gets no gradient, and the forward saves `xyzt`, not corners. CUDA
tensors go through `FieldInterpKernel`, CPU tensors through
`PlainFieldInterp`, whose directions are the plain versions
`field_interp_plain` (the corner math, then `fused_interp_plain`) and
`field_interp_bwd_plain`. There is no fallback: a CUDA call that cannot
launch raises.

Bit-exactness with the JAX package: the grid scale is applied in float32
with the scale as a Python float (`x * scale + 0.5`), so `floor` picks the
same cell, and the spatial hash multiplies in int64 and wraps to uint32
before the XOR, which reproduces JAX's uint32 arithmetic bit for bit.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from humanrf_torch.models.hash_encoding import _CORNER_BITS, _HASH_PRIMES, HashGridConfig
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.ops.fused_interp import fused_interp_bwd_plain, fused_interp_plain

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

MODE_GRID, MODE_VECTOR = 0, 1
MAX_LEVELS = 32


class FieldSpec(ctypes.Structure):
    """`struct FieldSpec` of `csrc/field_interp.cu`, passed by value."""

    _fields_ = [
        ("mode", ctypes.c_int32),
        ("n_levels", ctypes.c_int32),
        ("scale", ctypes.c_float * MAX_LEVELS),
        ("resolution", ctypes.c_int32 * MAX_LEVELS),
        ("dense", ctypes.c_int32 * MAX_LEVELS),
    ]

    def levels(self):
        """→ (scales as float32 values, resolutions, dense flags) of the grid's levels."""
        n = self.n_levels
        return list(self.scale[:n]), list(self.resolution[:n]), [bool(d) for d in self.dense[:n]]


@lru_cache(maxsize=16)
def grid_spec(cfg: HashGridConfig) -> FieldSpec:
    """The grid mode of a hash-grid configuration: per level its fp32 scale,
    its resolution and whether it indexes densely (res³ ≤ T). Cached (~44 µs
    to build, twice per step on a host-bound path); callers only read it."""
    scales, resolutions = cfg.level_scales(), cfg.level_resolutions()
    if not 1 <= len(scales) <= MAX_LEVELS:
        raise ValueError(f"field_interp takes 1..{MAX_LEVELS} levels, got {len(scales)}")
    spec = FieldSpec(mode=MODE_GRID, n_levels=len(scales))
    for level, (scale, res) in enumerate(zip(scales, resolutions)):
        spec.scale[level] = float(scale)
        spec.resolution[level] = int(res)
        spec.dense[level] = int(int(res) ** 3 <= cfg.table_size)
    return spec


VECTOR_SPEC = FieldSpec(mode=MODE_VECTOR, n_levels=0)

# Kernel launches since the last reset, per direction (each wrapper adds one
# where it launches its kernel).
launches = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    launches["fwd"] = launches["bwd"] = 0


def _grid_corner_idx_w(pts: torch.Tensor, level_scales, level_resolutions, table_size: int, dense=None):
    """pts (N, 3) in [0,1] → idx (L, 8, N) int32, w (L, 8, N) f32. `dense`
    per level defaults to res³ ≤ table_size."""
    x = pts.clamp(0.0, 1.0)
    idx_levels, w_levels = [], []
    for level in range(len(level_scales)):
        scaled = x * float(level_scales[level]) + 0.5
        floor = torch.floor(scaled)
        frac = scaled - floor
        base = floor.long()
        res = int(level_resolutions[level])
        is_dense = res**3 <= table_size if dense is None else dense[level]

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


def corner_idx_w(xyzt: torch.Tensor, spec: FieldSpec, table_size: int):
    """The corners the kernels compute, as tensors: xyzt (N, 4) → idx
    (P, C, N) int32, w (P, C, N) f32 (grid: P = 4L, C = 8; vector: P = 4, C = 2)."""
    if spec.mode == MODE_VECTOR:
        return _vector_idx_w(xyzt.clamp(0.0, 1.0), table_size)
    scales, resolutions, dense = spec.levels()
    idx, w = [], []
    for _, axes in _GRID_AXES:
        idx_g, w_g = _grid_corner_idx_w(xyzt[:, list(axes)], scales, resolutions, table_size, dense)
        idx.append(idx_g)
        w.append(w_g)
    return torch.cat(idx).contiguous(), torch.cat(w).contiguous()  # (4L, 8, N)


def field_interp_plain(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """The corner math, then `fused_interp_plain`; out-of-table corners add nothing."""
    return fused_interp_plain(tables, *corner_idx_w(xyzt, spec, tables.shape[2]))


def field_interp_bwd_plain(g: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec, table_size: int) -> torch.Tensor:
    """The corner math, then `fused_interp_bwd_plain`: dtab (P, F, T)."""
    return fused_interp_bwd_plain(g, *corner_idx_w(xyzt, spec, table_size), table_size)


def _check(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec):
    if tables.dim() != 3 or xyzt.dim() != 2 or xyzt.shape[1] != 4:
        raise ValueError(f"expected tables (P,F,T) and xyzt (N,4); got {tuple(tables.shape)}, {tuple(xyzt.shape)}")
    if tables.dtype != torch.float32 or xyzt.dtype != torch.float32:
        raise TypeError(f"expected float32 tables and xyzt, got {tables.dtype}/{xyzt.dtype}")
    if tables.device != xyzt.device:
        raise ValueError(f"tensors on different devices: {tables.device}, {xyzt.device}")
    pairs = 4 * spec.n_levels if spec.mode == MODE_GRID else 4
    if spec.mode not in (MODE_GRID, MODE_VECTOR) or tables.shape[0] != pairs:
        raise ValueError(f"tables {tuple(tables.shape)} do not fit a field spec of mode {spec.mode}, "
                         f"{spec.n_levels} levels ({pairs} pairs)")


def _run(name: str, first: torch.Tensor, xyzt: torch.Tensor, out: torch.Tensor, spec: FieldSpec, F: int, T: int):
    fn = getattr(load_library("field_interp").lib, name)
    if fn.argtypes is None:
        # in0, xyzt, out; spec; P, F; T, N; stream.
        fn.argtypes = [ctypes.c_void_p] * 3 + [FieldSpec] + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if xyzt.data_ptr() % 16:
        xyzt = xyzt.clone()  # the kernels read a sample as one 16-byte float4
    P, N = first.shape[0], xyzt.shape[0]
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = fn(first.data_ptr(), xyzt.data_ptr(), out.data_ptr(), spec, P, F, T, N, stream)
    if err != 0:
        # 1 (invalid value): P must be 4L (grid) or 4 (vector), at most 65,535; T < 2^31.
        raise RuntimeError(f"{name} launch failed at P={P}, F={F}, T={T}, N={N}, mode {spec.mode}: cudaError {err}")


def _launch_fwd(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    P, F, T = tables.shape
    out = torch.empty((P, F, xyzt.shape[0]), dtype=torch.float32, device=tables.device)
    _run("field_interp_fwd", tables.contiguous(), xyzt.contiguous(), out, spec, F, T)
    launches["fwd"] += 1
    return out


def _launch_bwd(g: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec, table_size: int) -> torch.Tensor:
    P, F, N = g.shape
    if g.dtype != torch.float32 or N != xyzt.shape[0] or g.device != xyzt.device:
        raise ValueError(f"expected g (P,F,N) float32 beside xyzt {tuple(xyzt.shape)}, got {tuple(g.shape)} {g.dtype}")
    dtab = torch.zeros((P, F, table_size), dtype=torch.float32, device=g.device)
    _run("field_interp_bwd", g.contiguous(), xyzt.contiguous(), dtab, spec, F, table_size)
    launches["bwd"] += 1
    return dtab


class FieldInterpKernel(torch.autograd.Function):
    """Both directions on the CUDA kernels; the forward saves `xyzt` only."""

    @staticmethod
    def forward(ctx, tables, xyzt, spec):
        ctx.save_for_backward(xyzt)
        ctx.spec, ctx.table_size = spec, tables.shape[2]
        return _launch_fwd(tables, xyzt, spec)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (xyzt,) = ctx.saved_tensors
        return _launch_bwd(g, xyzt, ctx.spec, ctx.table_size), None, None


class PlainFieldInterp(torch.autograd.Function):
    """Both directions in plain PyTorch: `field_interp_plain` and
    `field_interp_bwd_plain`, the corners recomputed from `xyzt`."""

    @staticmethod
    def forward(ctx, tables, xyzt, spec):
        ctx.save_for_backward(xyzt)
        ctx.spec, ctx.table_size = spec, tables.shape[2]
        return field_interp_plain(tables, xyzt, spec)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (xyzt,) = ctx.saved_tensors
        return field_interp_bwd_plain(g.contiguous(), xyzt, ctx.spec, ctx.table_size), None, None


def field_interp(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """tables (P, F, T) f32, xyzt (N, 4) f32 in [0, 1] → (P, F, N) f32,
    differentiable in `tables`.

    CUDA tensors go through the CUDA kernels, CPU tensors through the plain
    versions; anything else raises.
    """
    _check(tables, xyzt, spec)
    if tables.device.type == "cuda":
        return FieldInterpKernel.apply(tables, xyzt, spec)
    if tables.device.type == "cpu":
        return PlainFieldInterp.apply(tables, xyzt, spec)
    raise ValueError(f"field_interp runs on cuda or cpu tensors, not {tables.device}")
