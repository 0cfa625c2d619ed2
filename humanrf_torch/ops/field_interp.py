"""The field's table lookups with their corner math: the field query
`field_query(fields, xyzt)`, the main path, and the per-pair lookup
`field_interp(tables, xyzt, spec)` of its plain version.

`field_query` computes a sample's features from every segment's tables, on
CUDA tensors in one kernel launch each way (`FieldQueryKernel`, the kernels
of `humanrf_torch/csrc/field_interp.cu`, whose source note says what bounds
them and how the design answers): the four grids' and vectors' lookups, the
composition f_xyz⊙v_t + f_xyt⊙v_z + f_yzt⊙v_x + f_xzt⊙v_y and the routing of
each sample to its own segment (`seg`), so no (4, L·F, N) lookup exists; the
backward recomputes the lookups and adds each table's gradient straight into
its `.grad` where that is already there and the caller asked for it
(`grads_in_place`, `grad_in_place`). Its plain version,
`field_query_plain`, is the same query in PyTorch: per segment a grid and a
vector `field_interp` call, their sum over segments, `compose`. CPU tensors
take it, and on the card it is the reference: the kernels' forward equals it
bit for bit, their backward (fp32 atomics, in a run-dependent order) is held
to `field_query_bwd_plain` summed in fp64.

`field_interp` is the counterpart of what `humanrf_tpu/models/fused_field.py`
does around each `fused_interp` call: the corner indices and weights of
every sample (`_grid_corner_idx_w`, `_vector_idx_w`), then the interpolating
lookup `out[p, f, n] = Σ_c w[p, c, n] · tables[p, f, idx[p, c, n]]`
(`ops/fused_interp.py`). Two modes, described by a `FieldSpec`:

- grid (`grid_spec(HashGridConfig)`): tables (4L, F, T), pair g·L + l is
  grid g of `_GRID_AXES` at level l, 8 corners each;
- vector (`VECTOR_SPEC`): tables (4, D, R), pair p reads coordinate p of
  `xyzt`, 2 clamped taps.

Two optional inputs skip samples, both read from device memory so that no
call reads the device from the host and a CUDA graph replays it unchanged:
`n_valid`, a one-element int32 tensor (samples at or past it are skipped:
the empty tail of a static sample budget), and `seg`, an (N,) int32 segment
id per sample with `s` the segment served (other segments' samples are
skipped: the JAX package's where-masked routing, without its `lax.cond`). A
skipped sample's output is 0 and it adds nothing to the gradient; the
field query's kernels skip identically.

`field_interp` is differentiable in `tables` only, as the JAX `custom_vjp`
is: `xyzt` gets no gradient, and the forward saves `xyzt`, not corners
(`PlainFieldInterp`, whose directions are the plain versions
`field_interp_plain` and `field_interp_bwd_plain`).

Bit-exactness with the JAX package: the grid scale is applied in float32
with the scale as a Python float (`x * scale + 0.5`), so `floor` picks the
same cell, and the spatial hash multiplies in int64 and wraps to uint32
before the XOR, which reproduces JAX's uint32 arithmetic bit for bit.
"""
from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from humanrf_torch.models.hash_encoding import _CORNER_BITS, _HASH_PRIMES, HashGridConfig
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.ops.fused_interp import fused_interp_bwd_plain, fused_interp_plain
from humanrf_torch.utils import profiling

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
    """A lookup's mode and, for a grid, its levels: per level the fp32
    scale, the resolution and whether it indexes densely. The field query
    copies a segment's levels into its `FieldQuery`."""

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

# The field query's kernel launches since the last reset, per direction (each
# wrapper adds one where it launches its kernel).
launches = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def served(n: int, device, n_valid=None, seg=None, s: int = 0):
    """(n,) bool: the samples a call with these skip inputs serves (below
    `n_valid`, of segment `s`), or None when it serves every one. Device
    ops only: no host read."""
    live = None
    if n_valid is not None:
        live = torch.arange(n, device=device) < n_valid.reshape(())
    if seg is not None:
        live = seg == s if live is None else live & (seg == s)
    return live


def field_interp_plain(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec, n_valid=None, seg=None,
                       s: int = 0) -> torch.Tensor:
    """The corner math, then `fused_interp_plain`; out-of-table corners add
    nothing, skipped samples read 0."""
    out = fused_interp_plain(tables, *corner_idx_w(xyzt, spec, tables.shape[2]))
    live = served(xyzt.shape[0], xyzt.device, n_valid, seg, s)
    return out if live is None else torch.where(live, out, 0.0)


def field_interp_bwd_plain(g: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec, table_size: int, n_valid=None,
                           seg=None, s: int = 0) -> torch.Tensor:
    """The corner math, then `fused_interp_bwd_plain`: dtab (P, F, T). A
    skipped sample's cotangent is taken as 0, so it adds exact zeros."""
    live = served(xyzt.shape[0], xyzt.device, n_valid, seg, s)
    if live is not None:
        g = torch.where(live, g, 0.0)
    return fused_interp_bwd_plain(g, *corner_idx_w(xyzt, spec, table_size), table_size)


def _check(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec, n_valid=None, seg=None):
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
    for name, t, shape in (("n_valid", n_valid, None), ("seg", seg, (xyzt.shape[0],))):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.device != xyzt.device or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor on {xyzt.device}, got {t.dtype} on {t.device}")
        if (t.numel() != 1) if shape is None else (tuple(t.shape) != shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected {'one element' if shape is None else shape}")


class PlainFieldInterp(torch.autograd.Function):
    """Both directions in plain PyTorch: `field_interp_plain` and
    `field_interp_bwd_plain`, the corners recomputed from `xyzt`; the
    forward saves `xyzt` and the skip inputs given, no (P, C, N) corners."""

    @staticmethod
    def forward(ctx, tables, xyzt, spec, n_valid=None, seg=None, s=0):
        ctx.skips = (n_valid is not None, seg is not None)
        ctx.save_for_backward(xyzt, *(t for t in (n_valid, seg) if t is not None))
        ctx.spec, ctx.table_size, ctx.s = spec, tables.shape[2], s
        return field_interp_plain(tables, xyzt, spec, n_valid, seg, s)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        xyzt = next(saved)
        n_valid, seg = (next(saved) if given else None for given in ctx.skips)
        dtab = field_interp_bwd_plain(g.contiguous(), xyzt, ctx.spec, ctx.table_size, n_valid, seg, ctx.s)
        return dtab, None, None, None, None, None


def field_interp(tables: torch.Tensor, xyzt: torch.Tensor, spec: FieldSpec, n_valid: Optional[torch.Tensor] = None,
                 seg: Optional[torch.Tensor] = None, s: int = 0) -> torch.Tensor:
    """tables (P, F, T) f32, xyzt (N, 4) f32 in [0, 1] → (P, F, N) f32,
    differentiable in `tables`, in plain PyTorch on any device. `n_valid`
    (one int32) and `seg` ((N,) int32, serving segment `s`) skip samples
    (see the module docstring)."""
    _check(tables, xyzt, spec, n_valid, seg)
    return PlainFieldInterp.apply(tables, xyzt, spec, n_valid, seg, s)


# ------------------------------------------------------------ the field query

MAX_SEGMENTS = 256  # kMaxSegments of csrc/field_interp.cu


def _aligned(xyzt: torch.Tensor) -> torch.Tensor:
    """`xyzt` contiguous and 16-byte aligned: the kernels read a sample as one
    float4. The main path's xyzt is a fresh `torch.cat` (the allocator's
    blocks are 512-byte aligned), so this copies only a caller's offset view,
    once per query: the forward saves the aligned tensor for the backward
    (and under CUDA graph capture the copy comes from the graph's pool, at
    the same address on every replay)."""
    xyzt = xyzt.contiguous()
    return xyzt.clone() if xyzt.data_ptr() % 16 else xyzt


class SegmentTables(ctypes.Structure):
    """`struct SegmentTables` of `csrc/field_interp.cu`."""

    _fields_ = [
        ("grid", ctypes.c_void_p * 4),
        ("vectors", ctypes.c_void_p),
        ("dgrid", ctypes.c_void_p * 4),
        ("dvectors", ctypes.c_void_p),
        ("T", ctypes.c_uint32),
        ("dense", ctypes.c_uint32),
    ]


class FieldQuery(ctypes.Structure):
    """`struct FieldQuery` of `csrc/field_interp.cu`, passed by value."""

    _fields_ = [
        ("n_segments", ctypes.c_int32),
        ("n_levels", ctypes.c_int32),
        ("F", ctypes.c_int32),
        ("R", ctypes.c_int32),
        ("scale", ctypes.c_float * MAX_LEVELS),
        ("resolution", ctypes.c_int32 * MAX_LEVELS),
        ("seg", SegmentTables * MAX_SEGMENTS),
    ]


class SegmentField(NamedTuple):
    """One segment's part of a field query: `grids`, its four (L, F, T)
    tables xyz, xyt, yzt, xzt, or one (4L, F, T) stack of them (the FSDP
    step's gathered tables); `vectors` (4, L·F, R); `spec`, the grid spec of
    its hash-grid configuration (`grid_spec`)."""

    grids: Tuple[torch.Tensor, ...]
    vectors: torch.Tensor
    spec: FieldSpec


def compose(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The grids' and vectors' lookups (4, D, N) → (N, D) features,
    f_xyz⊙v_t + f_xyt⊙v_z + f_yzt⊙v_x + f_xzt⊙v_y."""
    out = f[0] * v[_PARTNER_VECTOR[0]]
    for g in range(1, 4):
        out = out + f[g] * v[_PARTNER_VECTOR[g]]
    return out.T


def _stack(field: SegmentField) -> torch.Tensor:
    return field.grids[0] if len(field.grids) == 1 else torch.cat(field.grids, dim=0)


def field_query_plain(fields: Sequence[SegmentField], xyzt: torch.Tensor, n_valid=None,
                      seg=None) -> torch.Tensor:
    """The field query as `field_interp` calls: per segment s a grid call and
    a vector call serving the samples whose `seg` is s (all of them without
    `seg`), each (4, L·F, N) with zeros elsewhere; the sum over segments;
    `compose`. Plain PyTorch both ways on any device, differentiable in the
    tables through `field_interp`: the field query's kernels equal it bit
    for bit forward."""
    n = xyzt.shape[0]
    grid = vectors = None
    for s, field in enumerate(fields):
        f = field_interp(_stack(field), xyzt, field.spec, n_valid, seg, s).reshape(4, -1, n)
        v = field_interp(field.vectors, xyzt, VECTOR_SPEC, n_valid, seg, s)
        grid, vectors = (f, v) if grid is None else (grid + f, vectors + v)
    return compose(grid, vectors)


def field_query_bwd_plain(fields: Sequence[SegmentField], xyzt: torch.Tensor, grad: torch.Tensor, n_valid=None,
                          seg=None) -> list:
    """The field query's backward in PyTorch, in `grad`'s type (fp32, or
    fp64 sums as a reference): the lookups recomputed in fp32 by
    `field_interp_plain`, the cotangents grad⊙v_p of grid g and grad⊙f_g of
    its partner vector p, then `field_interp_bwd_plain`. → the gradients of
    every field's grids (as given: four tables or one stack) and vectors, in
    that order."""
    n = xyzt.shape[0]
    g = grad.T
    out = []
    for s, field in enumerate(fields):
        stack = _stack(field)
        L = stack.shape[0] // 4
        f = field_interp_plain(stack, xyzt, field.spec, n_valid, seg, s).reshape(4, -1, n).to(g.dtype)
        v = field_interp_plain(field.vectors, xyzt, VECTOR_SPEC, n_valid, seg, s).to(g.dtype)
        df = torch.stack([g * v[_PARTNER_VECTOR[i]] for i in range(4)])
        dv = torch.empty_like(df)
        for i in range(4):
            dv[_PARTNER_VECTOR[i]] = g * f[i]
        dstack = field_interp_bwd_plain(df.reshape(stack.shape[0], stack.shape[1], n).contiguous(), xyzt, field.spec,
                                        stack.shape[2], n_valid, seg, s)
        out.extend(dstack.split(L) if len(field.grids) == 4 else (dstack,))
        out.append(field_interp_bwd_plain(dv.contiguous(), xyzt, VECTOR_SPEC, field.vectors.shape[2], n_valid, seg, s))
    return out


def _check_query(fields: Sequence[SegmentField], xyzt: torch.Tensor, n_valid=None, seg=None) -> None:
    if not 1 <= len(fields) <= MAX_SEGMENTS:
        raise ValueError(f"a field query takes 1..{MAX_SEGMENTS} segments, got {len(fields)}")
    if len(fields) > 1 and seg is None:
        raise ValueError(f"a field query over {len(fields)} segments needs `seg` to route its samples")
    first = fields[0].spec
    for s, field in enumerate(fields):
        spec = field.spec
        if spec.mode != MODE_GRID or (spec.n_levels, spec.levels()[:2]) != (first.n_levels, first.levels()[:2]):
            raise ValueError(f"segment {s}'s grid spec differs from segment 0's in its levels or mode")
        L, first_grid = spec.n_levels, field.grids[0]
        shape = (4 * L if len(field.grids) == 1 else L, *first_grid.shape[1:])
        if len(field.grids) not in (1, 4) or first_grid.dim() != 3 or any(t.shape != shape for t in field.grids):
            raise ValueError(f"segment {s}'s grids {[tuple(t.shape) for t in field.grids]} are not four "
                             f"(L, F, T) tables or one (4L, F, T) stack at L = {L}")
        F = first_grid.shape[1]
        if field.vectors.dim() != 3 or field.vectors.shape[:2] != (4, L * F):
            raise ValueError(f"segment {s}'s vectors {tuple(field.vectors.shape)} are not (4, {L * F}, R)")
        if field.vectors.shape[2] != fields[0].vectors.shape[2] or F != fields[0].grids[0].shape[1]:
            raise ValueError(f"segment {s}'s vector resolution or features differ from segment 0's")
        for t in (*field.grids, field.vectors):
            if t.dtype != torch.float32 or t.device != xyzt.device:
                raise TypeError(f"segment {s}'s tables must be float32 on {xyzt.device}, got {t.dtype} on {t.device}")
    if xyzt.dim() != 2 or xyzt.shape[1] != 4 or xyzt.dtype != torch.float32:
        raise ValueError(f"expected float32 xyzt (N, 4), got {tuple(xyzt.shape)} {xyzt.dtype}")
    _check(fields[0].vectors, xyzt, VECTOR_SPEC, n_valid, seg)  # the skip inputs


def _query_struct(fields: Sequence[SegmentField], grads=None) -> FieldQuery:
    """The kernels' FieldQuery: levels from segment 0's spec, each segment's
    table pointers (a stack's four grids at their offsets), size and dense
    levels, and with `grads` (one tensor per table, as `_flat` orders them)
    the gradients' pointers."""
    spec = fields[0].spec
    F = fields[0].grids[0].shape[1]
    q = FieldQuery(n_segments=len(fields), n_levels=spec.n_levels, F=F, R=fields[0].vectors.shape[2])
    scales, resolutions, _ = spec.levels()
    for level in range(spec.n_levels):
        q.scale[level], q.resolution[level] = scales[level], resolutions[level]
    def grid_ptrs(tensors):  # four tables, or a stack's four grids at their offsets
        if len(tensors) == 4:
            return [t.data_ptr() for t in tensors]
        return [tensors[0].data_ptr() + g * (tensors[0].numel() // 4) * tensors[0].element_size() for g in range(4)]

    it = iter(grads) if grads is not None else None
    for s, field in enumerate(fields):
        st = q.seg[s]
        st.T = field.grids[0].shape[2]
        st.dense = sum(1 << level for level, d in enumerate(field.spec.levels()[2]) if d)
        st.grid[:], st.vectors = grid_ptrs(field.grids), field.vectors.data_ptr()
        if it is not None:
            st.dgrid[:] = grid_ptrs([next(it) for _ in field.grids])
            st.dvectors = next(it).data_ptr()
    return q


def _query_fn(name: str):
    fn = getattr(load_library("field_interp").lib, name)
    if fn.argtypes is None:
        # q; xyzt, out or grad; N; n_valid, seg; stream.
        fn.argtypes = [FieldQuery, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def _run_query(name: str, fields, xyzt: torch.Tensor, second: torch.Tensor, n_valid, seg, grads=None) -> None:
    q = _query_struct(fields, grads)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(xyzt.device):
        stream = torch.cuda.current_stream(xyzt.device).cuda_stream
        err = _query_fn(name)(q, xyzt.data_ptr(), second.data_ptr(), xyzt.shape[0], ptr(n_valid), ptr(seg), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed at {len(fields)} segments, L={q.n_levels}, F={q.F}, R={q.R}, "
                           f"N={xyzt.shape[0]}: cudaError {err}")


def _launch_query_fwd(fields: Sequence[SegmentField], xyzt: torch.Tensor, n_valid=None, seg=None) -> torch.Tensor:
    """One forward launch: (N, L·F) features."""
    fields = [SegmentField(tuple(t.contiguous() for t in f.grids), f.vectors.contiguous(), f.spec) for f in fields]
    xyzt = _aligned(xyzt)
    out = torch.empty((xyzt.shape[0], fields[0].vectors.shape[1]), dtype=torch.float32, device=xyzt.device)
    if xyzt.shape[0] == 0:
        return out  # nothing to launch
    _run_query("field_query_fwd", fields, xyzt, out, n_valid, seg)
    launches["fwd"] += 1
    return out


# Whether a backward launch may add into a tensor's own `.grad`: off but
# inside `grads_in_place()`. A module global, not a thread-local: autograd
# runs a CUDA backward on its own device thread.
_in_place = False


@contextlib.contextmanager
def grads_in_place():
    """Let the backward launches inside the block add a table's gradient
    straight into its `.grad` (`grad_in_place`). The single-process train
    step opens it around its own `loss.backward()`, which accumulates into
    the zeroed `.grad` anyway; every other caller (`torch.autograd.grad`, a
    multi-rank step, a test) gets autograd's ordinary result, a gradient
    returned in a fresh buffer."""
    global _in_place
    was, _in_place = _in_place, True
    try:
        yield
    finally:
        _in_place = was


def grad_in_place(t: torch.Tensor) -> bool:
    """Whether the backward launch adds `t`'s gradient straight into
    `t.grad`: inside `grads_in_place()`, where `t` is a leaf that requires a
    gradient, and its `.grad` is there, dense, contiguous, float32, of `t`'s
    shape and on its device (the train step's gradients, zeroed in place
    before the forward). The kernel only adds, so that gives what autograd's
    `.grad += ` of a fresh zeroed buffer gives, without the buffer, its fill
    and the add. Anything else (outside the block, no `.grad` yet, the FSDP
    step's gathered stacks, which are no leaves) takes a fresh buffer."""
    if not (_in_place and t.is_leaf and t.requires_grad):
        return False
    g = t.grad
    return (g is not None and g.layout == torch.strided and g.is_contiguous() and g.dtype == torch.float32
            and g.shape == t.shape and g.device == t.device)


def _grad_buffers(tensors: Sequence[torch.Tensor]) -> Tuple[list, list]:
    """→ (per tensor the buffer its gradient is added into: its own `.grad`
    where `grad_in_place`, else a fresh zeroed one; the in-place flags).
    Sets the recorder's gauges `field.grads_in_place` and `field.grads_fresh`
    to the entries of each kind."""
    in_place = [grad_in_place(t) for t in tensors]
    buffers = [t.grad if own else torch.zeros_like(t) for t, own in zip(tensors, in_place)]
    profiling.gauge("field.grads_in_place", sum(t.numel() for t, own in zip(tensors, in_place) if own))
    profiling.gauge("field.grads_fresh", sum(t.numel() for t, own in zip(tensors, in_place) if not own))
    return buffers, in_place


def _launch_query_bwd(fields: Sequence[SegmentField], xyzt: torch.Tensor, grad: torch.Tensor, n_valid=None,
                      seg=None) -> list:
    """One backward launch → per table and vector of every field, in
    `_flat`'s order, its gradient, or None where the launch added it into
    the tensor's own `.grad` (`grad_in_place`)."""
    fields = [SegmentField(tuple(t.contiguous() for t in f.grids), f.vectors.contiguous(), f.spec) for f in fields]
    xyzt = _aligned(xyzt)
    if grad.dtype != torch.float32 or tuple(grad.shape) != (xyzt.shape[0], fields[0].vectors.shape[1]):
        raise ValueError(f"expected a float32 cotangent {(xyzt.shape[0], fields[0].vectors.shape[1])}, got "
                         f"{tuple(grad.shape)} {grad.dtype}")
    buffers, in_place = _grad_buffers(_flat(fields))
    if xyzt.shape[0] > 0:  # else nothing to launch
        _run_query("field_query_bwd", fields, xyzt, grad.contiguous(), n_valid, seg, buffers)
        launches["bwd"] += 1
    return [None if own else b for b, own in zip(buffers, in_place)]


def _flat(fields: Sequence[SegmentField]) -> list:
    return [t for f in fields for t in (*f.grids, f.vectors)]


def _unflat(layout, tensors) -> list:
    """The fields again from `_flat`'s tensors and their (spec, number of grid tensors) layout."""
    it = iter(tensors)
    return [SegmentField(tuple(next(it) for _ in range(k)), next(it), spec) for spec, k in layout]


class FieldQueryKernel(torch.autograd.Function):
    """Both directions of a field query on its CUDA kernels, one launch
    each; the forward saves `xyzt`, the skip inputs and the tables, no
    lookup. Inside `grads_in_place()` the backward adds the gradient of a
    table whose `.grad` is there straight into it and returns None for that
    table, so autograd adds nothing more (`grad_in_place`); the train step
    asks for that only around its `backward` over all the tables. Elsewhere
    it returns every gradient, as autograd expects."""

    @staticmethod
    def forward(ctx, layout, xyzt, n_valid, seg, *tensors):
        xyzt = _aligned(xyzt)
        ctx.layout, ctx.skips = layout, (n_valid is not None, seg is not None)
        ctx.save_for_backward(xyzt, *(t for t in (n_valid, seg) if t is not None), *tensors)
        return _launch_query_fwd(_unflat(layout, tensors), xyzt, n_valid, seg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        saved = iter(ctx.saved_tensors)
        xyzt = next(saved)
        n_valid, seg = (next(saved) if given else None for given in ctx.skips)
        grads = _launch_query_bwd(_unflat(ctx.layout, list(saved)), xyzt, grad, n_valid, seg)
        return (None, None, None, None, *grads)


def field_query(fields: Sequence[SegmentField], xyzt: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 4D field's features: `fields`, one `SegmentField` per segment;
    xyzt (N, 4) f32 in [0, 1] → (N, L·F) f32, differentiable in every
    segment's grids and vectors. `seg` ((N,) int32) routes sample n to
    segment seg[n] (a sample of no segment, seg outside [0, len(fields)),
    gets zeros; without `seg` every sample is segment 0's); samples at or
    past `n_valid` (one int32) get zeros.

    CUDA tensors go through the field query's kernels (one launch each
    way), CPU tensors through `field_query_plain`; anything else raises."""
    _check_query(fields, xyzt, n_valid, seg)
    if xyzt.device.type == "cuda":
        layout = tuple((f.spec, len(f.grids)) for f in fields)
        return FieldQueryKernel.apply(layout, xyzt, n_valid, seg, *_flat(fields))
    if xyzt.device.type == "cpu":
        return field_query_plain(fields, xyzt, n_valid, seg)
    raise ValueError(f"field_query runs on cuda or cpu tensors, not {xyzt.device}")
