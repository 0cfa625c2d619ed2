"""The K-Planes field's plane query: every scale's six plane lookups and
their product, `plane_query(planes, coords)`; and its plane regularisers,
`plane_regularization(fields, weights)`.

A field of S scales holds, per scale, six planes, the axis pairs (i, j) of
`itertools.combinations(range(4), 2)` over (x, y, z, t): xy, xz, xt, yz,
yt, zt (`PLANES`). Plane (i, j) is a (res_j, res_i, M) float32 tensor,
channels last: texel (row, col) holds M consecutive channels, row along
axis j, col along axis i. A sample q = (x, y, z, t) in [-1, 1]^4 reads, per
scale s,

    f_s(q) = prod_p  bilinear(P_p^s, (q_i, q_j))      (M channels)

with `F.grid_sample`'s bilinear sampling, `align_corners=True` and border
padding; the features are f_1 ... f_S concatenated, (N, S·M).

CUDA tensors go through the kernels of `humanrf_torch/csrc/kplanes.cu`
(`PlaneQueryKernel`, one launch each way a query, whose source note says
what bounds them and how the design answers); CPU tensors through
`plane_query_plain`, the same arithmetic in PyTorch, which the forward
kernel equals bit for bit. The backward kernel adds each plane's gradient
straight into its `.grad` under the rule of `ops/field_interp.py::
grad_in_place` (inside `grads_in_place()` only), else into a fresh zeroed
buffer; its plain version `plane_query_bwd_plain` sums in the cotangent's
type (fp64 as the card's reference).

Two optional inputs skip samples, as the field query's do: `n_valid`, one
int32 (samples at or past it are skipped), and `seg`, (N,) int32 (a sample
whose entry is negative is skipped). A skipped sample's features are 0 and
it adds nothing to the gradient. Only the planes are differentiated: the
coordinates get no gradient.

`plane_regularization(fields, weights)` is the plane regularisers of every
plane field on the card: plane TV over each scale's spatial planes, time
smoothness and the L1 distance from 1 over its time planes, each term a mean
over a plane's entries, weighted by its field's (tv, smoothness, l1) and
summed into one scalar; two launches forward and one backward over every
plane of every field (`PlaneRegKernel`). Its backward adds each plane's
analytic gradient into its `.grad` under the same in-place rule, and
`plane_reg_bwd_plain` is its arithmetic in PyTorch, which the kernel equals
bit for bit. Its CPU version is the plain formulas that autograd
differentiates (`models/kplanes.py::plane_regularizers`).
"""
from __future__ import annotations

import ctypes
import itertools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.utils import profiling

PLANES = tuple(itertools.combinations(range(4), 2))  # xy, xz, xt, yz, yt, zt
PLANE_NAMES = tuple("".join("xyzt"[a] for a in pair) for pair in PLANES)
SPATIAL_PLANES = tuple(p for p, (i, j) in enumerate(PLANES) if j < 3)  # xy, xz, yz
TIME_PLANES = tuple(p for p, (i, j) in enumerate(PLANES) if j == 3)    # xt, yt, zt

MAX_SCALES = 4  # kMaxScales of csrc/kplanes.cu
# The kernels' instances: (channels, scales).
KERNEL_WIDTHS = (8, 32)
KERNEL_SCALES = (1, 4)

# The kernel launches since the last reset: the query's per direction, and
# the regularisers' (two a forward, one a backward).
launches = {"fwd": 0, "bwd": 0, "reg_fwd": 0, "reg_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def plane_shape(resolution: Sequence[int], p: int, channels: int) -> tuple:
    """Plane p's shape at a scale of per-axis sizes `resolution` (x, y, z, t)."""
    i, j = PLANES[p]
    return (int(resolution[j]), int(resolution[i]), channels)


def _taps(c: torch.Tensor, size: int):
    """(N,) coordinates in [-1, 1] along an axis of `size` → (i0, i1, frac,
    1 − frac): `grid_sample`'s align_corners=True border sampling."""
    pix = ((c + 1.0) * 0.5) * float(size - 1)
    pix = pix.clamp(0.0, float(size - 1))
    fl = torch.floor(pix)
    i0 = fl.long()
    i1 = (i0 + 1).clamp(max=size - 1)
    fr = pix - fl
    return i0, i1, fr, 1.0 - fr


def _corners(taps, plane_pair, width: int):
    """One plane's four taps: texel indices (row·W + col) and weights, in
    the kernels' order (row0 col0, row0 col1, row1 col0, row1 col1)."""
    i, j = plane_pair
    u0, u1, fu, ou = taps[i]
    v0, v1, fv, ov = taps[j]
    idx = (v0 * width + u0, v0 * width + u1, v1 * width + u0, v1 * width + u1)
    w = (ou * ov, fu * ov, ou * fv, fu * fv)
    return idx, w


def _live(n: int, device, n_valid=None, seg=None) -> Optional[torch.Tensor]:
    live = None
    if n_valid is not None:
        live = torch.arange(n, device=device) < n_valid.reshape(())
    if seg is not None:
        live = seg >= 0 if live is None else live & (seg >= 0)
    return live


def _lookup(plane: torch.Tensor, idx, w) -> torch.Tensor:
    """A plane's value at the samples: its taps summed in order, each product
    and sum rounded on its own (the kernels' order)."""
    rows = plane.reshape(-1, plane.shape[-1])
    v = w[0][:, None] * rows[idx[0]]
    for k in range(1, 4):
        v = v + w[k][:, None] * rows[idx[k]]
    return v


def plane_query_plain(planes: Sequence[torch.Tensor], coords: torch.Tensor, n_valid=None, seg=None) -> torch.Tensor:
    """The query in plain PyTorch on any device, differentiable in the
    planes by autograd: `planes` scale-major, six a scale in `PLANES`'
    order; coords (N, 4) → (N, S·M)."""
    n = coords.shape[0]
    feats = []
    for s in range(len(planes) // 6):
        scale = planes[6 * s:6 * s + 6]
        res = _resolution(scale)
        taps = [_taps(coords[:, a], res[a]) for a in range(4)]
        f = None
        for p, pair in enumerate(PLANES):
            idx, w = _corners(taps, pair, res[pair[0]])
            v = _lookup(scale[p], idx, w)
            f = v if f is None else f * v
        feats.append(f)
    out = torch.cat(feats, dim=1)
    live = _live(n, coords.device, n_valid, seg)
    return out if live is None else torch.where(live[:, None], out, 0.0)


def plane_query_bwd_plain(planes: Sequence[torch.Tensor], coords: torch.Tensor, grad: torch.Tensor, n_valid=None,
                          seg=None) -> list:
    """The query's backward in PyTorch, in `grad`'s type (fp32, or fp64 sums
    as the card's reference): the plane values recomputed in fp32, then
    d value_p = grad ⊙ Π_{q≠p} value_q added into plane p's four taps with
    their weights. → each plane's gradient, in `planes`' order."""
    n = coords.shape[0]
    live = _live(n, coords.device, n_valid, seg)
    if live is not None:
        grad = torch.where(live[:, None], grad, 0.0)
    out = []
    for s in range(len(planes) // 6):
        scale = planes[6 * s:6 * s + 6]
        m = scale[0].shape[-1]
        g = grad[:, s * m:(s + 1) * m]
        res = _resolution(scale)
        taps = [_taps(coords[:, a], res[a]) for a in range(4)]
        corners = [_corners(taps, pair, res[pair[0]]) for pair in PLANES]
        values = [_lookup(scale[p], *corners[p]).to(g.dtype) for p in range(6)]
        for p in range(6):
            d = g
            for o in range(6):
                if o != p:
                    d = d * values[o]
            dplane = torch.zeros((scale[p].numel() // m, m), dtype=g.dtype, device=g.device)
            idx, w = corners[p]
            for k in range(4):
                dplane.index_add_(0, idx[k], w[k].to(g.dtype)[:, None] * d)
            out.append(dplane.reshape(scale[p].shape))
    return out


def _resolution(scale: Sequence[torch.Tensor]) -> list:
    """A scale's per-axis sizes (x, y, z, t) from its six planes' shapes."""
    res = [0, 0, 0, 0]
    for t, (i, j) in zip(scale, PLANES):
        res[j], res[i] = t.shape[0], t.shape[1]
    return res


def _check(planes: Sequence[torch.Tensor], coords: torch.Tensor, n_valid=None, seg=None) -> None:
    if not planes or len(planes) % 6 or len(planes) // 6 > MAX_SCALES:
        raise ValueError(f"a plane query takes six planes a scale and 1..{MAX_SCALES} scales, got {len(planes)}")
    m = planes[0].shape[-1]
    for s in range(len(planes) // 6):
        scale = planes[6 * s:6 * s + 6]
        res = _resolution(scale)
        for p, t in enumerate(scale):
            if tuple(t.shape) != plane_shape(res, p, m):
                raise ValueError(f"scale {s}'s planes {[tuple(x.shape) for x in scale]} do not share per-axis sizes "
                                 f"and {m} channels")
            if t.dtype != torch.float32 or t.device != coords.device:
                raise TypeError(f"planes must be float32 on {coords.device}, got {t.dtype} on {t.device}")
        if min(res) < 2:
            raise ValueError(f"scale {s} has an axis of fewer than 2 texels: {res}")
    if coords.dim() != 2 or coords.shape[1] != 4 or coords.dtype != torch.float32:
        raise ValueError(f"expected float32 coords (N, 4), got {tuple(coords.shape)} {coords.dtype}")
    for name, t, shape in (("n_valid", n_valid, None), ("seg", seg, (coords.shape[0],))):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.device != coords.device or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor on {coords.device}, got {t.dtype} on {t.device}")
        if (t.numel() != 1) if shape is None else (tuple(t.shape) != shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")


# ------------------------------------------------------------------ kernels


class PlaneQueryStruct(ctypes.Structure):
    """`struct PlaneQuery` of `csrc/kplanes.cu`, passed by value."""

    _fields_ = [
        ("n_scales", ctypes.c_int32),
        ("M", ctypes.c_int32),
        ("res", (ctypes.c_int32 * 4) * MAX_SCALES),
        ("plane", (ctypes.c_void_p * 6) * MAX_SCALES),
        ("dplane", (ctypes.c_void_p * 6) * MAX_SCALES),
    ]


def _struct(planes: Sequence[torch.Tensor], grads=None) -> PlaneQueryStruct:
    q = PlaneQueryStruct(n_scales=len(planes) // 6, M=planes[0].shape[-1])
    for s in range(q.n_scales):
        scale = planes[6 * s:6 * s + 6]
        q.res[s][:] = _resolution(scale)
        q.plane[s][:] = [t.data_ptr() for t in scale]
        if grads is not None:
            q.dplane[s][:] = [t.data_ptr() for t in grads[6 * s:6 * s + 6]]
    return q


def _fn(name: str):
    fn = getattr(load_library("kplanes").lib, name)
    if fn.argtypes is None:
        # q; coords, out or grad; N; n_valid, seg; stream.
        fn.argtypes = [PlaneQueryStruct, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def _run(name: str, planes, coords: torch.Tensor, second: torch.Tensor, n_valid, seg, grads=None) -> None:
    q = _struct(planes, grads)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = _fn(name)(q, coords.data_ptr(), second.data_ptr(), coords.shape[0], ptr(n_valid), ptr(seg), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed at {q.n_scales} scales, M={q.M}, N={coords.shape[0]}: "
                           f"cudaError {err}")


def _launch_fwd(planes, coords: torch.Tensor, n_valid=None, seg=None) -> torch.Tensor:
    """One forward launch: (N, S·M) features."""
    planes = [t.contiguous() for t in planes]
    coords = fli._aligned(coords)
    out = torch.empty((coords.shape[0], len(planes) // 6 * planes[0].shape[-1]), dtype=torch.float32,
                      device=coords.device)
    if coords.shape[0]:
        _run("kplanes_fwd", planes, coords, out, n_valid, seg)
        launches["fwd"] += 1
    return out


def _launch_bwd(planes, coords: torch.Tensor, grad: torch.Tensor, n_valid=None, seg=None) -> list:
    """One backward launch → per plane its gradient, or None where the
    launch added it into the plane's own `.grad` (`fli.grad_in_place`)."""
    planes = [t.contiguous() for t in planes]
    coords = fli._aligned(coords)
    width = len(planes) // 6 * planes[0].shape[-1]
    if grad.dtype != torch.float32 or tuple(grad.shape) != (coords.shape[0], width):
        raise ValueError(f"expected a float32 cotangent {(coords.shape[0], width)}, got {tuple(grad.shape)} "
                         f"{grad.dtype}")
    buffers, in_place = fli._grad_buffers(planes)
    if coords.shape[0]:
        _run("kplanes_bwd", planes, coords, fli._aligned(grad), n_valid, seg, buffers)
        launches["bwd"] += 1
    return [None if own else b for b, own in zip(buffers, in_place)]


class PlaneQueryKernel(torch.autograd.Function):
    """Both directions of a plane query on its CUDA kernels, one launch
    each; the forward saves the coordinates, the skip inputs and the planes.
    Inside `fli.grads_in_place()` the backward adds a plane's gradient into
    its `.grad` where that is there and returns None for it."""

    @staticmethod
    def forward(ctx, coords, n_valid, seg, *planes):
        coords = fli._aligned(coords)
        ctx.skips = (n_valid is not None, seg is not None)
        ctx.save_for_backward(coords, *(t for t in (n_valid, seg) if t is not None), *planes)
        return _launch_fwd(planes, coords, n_valid, seg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        saved = iter(ctx.saved_tensors)
        coords = next(saved)
        n_valid, seg = (next(saved) if given else None for given in ctx.skips)
        return (None, None, None, *_launch_bwd(list(saved), coords, grad.contiguous(), n_valid, seg))


def plane_query(planes: Sequence[torch.Tensor], coords: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The K-Planes features: `planes`, six a scale in `PLANES`' order,
    scale-major, each (res_j, res_i, M) float32; coords (N, 4) f32 in
    [-1, 1] → (N, S·M) f32, differentiable in the planes. `n_valid` and
    `seg` skip samples (see the module docstring).

    CUDA tensors go through the kernels (M in 8, 32 and 1 or 4 scales;
    other widths raise), CPU tensors through `plane_query_plain`."""
    _check(planes, coords, n_valid, seg)
    if coords.device.type == "cuda":
        if planes[0].shape[-1] not in KERNEL_WIDTHS or len(planes) // 6 not in KERNEL_SCALES:
            raise ValueError(f"the plane query's kernels take M in {KERNEL_WIDTHS} and {KERNEL_SCALES} scales, got "
                             f"M = {planes[0].shape[-1]}, {len(planes) // 6} scales")
        return PlaneQueryKernel.apply(coords.detach(), n_valid, seg, *planes)
    if coords.device.type == "cpu":
        return plane_query_plain(planes, coords.detach(), n_valid, seg)
    raise ValueError(f"plane_query runs on cuda or cpu tensors, not {coords.device}")


# ---------------------------------------------------------- the regularisers

MAX_REG_PLANES = 64  # kMaxRegPlanes of csrc/kplanes.cu
REG_THREADS = 256    # kRegThreads
REG_STRIP = 32       # kRegStrip: the rows a thread marches down
SPATIAL, TIME = 0, 1  # kSpatial, kTime


def reg_terms(fields: Sequence[Sequence[torch.Tensor]], weights: Sequence[Sequence[float]]) -> list:
    """Per plane of `fields` (each scale-major, six a scale in `PLANES`'
    order) with its field's (tv, smoothness, l1) weights → (kind, w0, w1),
    each weight over its term's count: a spatial plane (h, w, M) TV's
    2·tv / ((h−1)·w·M) on the squared row differences and 2·tv / (h·(w−1)·M)
    on the column ones; a time plane smoothness / ((h−2)·w·M) on the
    squared second differences along t and l1 / (h·w·M) on |1 − P|."""
    terms = []
    for planes, (tv, smooth, l1) in zip(fields, weights, strict=True):
        for i, t in enumerate(planes):
            h, w, m = t.shape
            if i % 6 in TIME_PLANES:
                terms.append((TIME, smooth / ((h - 2) * w * m), l1 / (h * w * m)))
            else:
                terms.append((SPATIAL, 2.0 * tv / ((h - 1) * w * m), 2.0 * tv / (h * (w - 1) * m)))
    return terms


def plane_reg_bwd_plain(fields: Sequence[Sequence[torch.Tensor]], weights: Sequence[Sequence[float]],
                        grad: torch.Tensor) -> list:
    """The regularisers' backward in PyTorch, the kernel's arithmetic: every
    product and sum rounded on its own in float32, in the kernel's order.
    `grad` is the scalar's cotangent (one float32) → each plane's gradient,
    in `fields`' order, plane by plane."""
    out = []
    planes = [t.detach() for f in fields for t in f]
    for t, (kind, w0, w1) in zip(planes, reg_terms(fields, weights)):
        c0 = grad * torch.tensor(2.0 * w0, dtype=torch.float32, device=t.device)
        if kind == SPATIAL:
            c1 = grad * torch.tensor(2.0 * w1, dtype=torch.float32, device=t.device)
            d = t[1:] - t[:-1]  # F.pad's last pair pads dim 0
            rows = F.pad(d, (0, 0, 0, 0, 1, 0)) - F.pad(d, (0, 0, 0, 0, 0, 1))
            d = t[:, 1:] - t[:, :-1]
            cols = F.pad(d, (0, 0, 1, 0)) - F.pad(d, (0, 0, 0, 1))
            out.append(c0 * rows + c1 * cols)
        else:
            c1 = grad * torch.tensor(w1, dtype=torch.float32, device=t.device)
            s = (t[2:] - t[1:-1]) - (t[1:-1] - t[:-2])  # s_k for k in [2, h)
            gs = (F.pad(s, (0, 0, 0, 0, 2, 0)) - 2.0 * F.pad(s, (0, 0, 0, 0, 1, 1))) + F.pad(s, (0, 0, 0, 0, 0, 2))
            out.append(c0 * gs + c1 * torch.sign(t - 1.0))
    return out


def _check_reg(fields: Sequence[Sequence[torch.Tensor]], weights: Sequence[Sequence[float]]) -> list:
    """→ the planes of every field, flat; raises unless they are float32,
    contiguous, (h, w, M) with M a multiple of 4, on one device, six a scale,
    spatial planes of at least 2 × 2 texels and time planes of at least 3 rows."""
    if not fields or len(fields) != len(weights) or any(len(w) != 3 for w in weights):
        raise ValueError(f"expected a (tv, smoothness, l1) weight per field, got {len(fields)} fields and {weights}")
    planes = [t for f in fields for t in f]
    if any(not f or len(f) % 6 for f in fields) or len(planes) > MAX_REG_PLANES:
        raise ValueError(f"the regularisers take six planes a scale and at most {MAX_REG_PLANES} planes, got "
                         f"{[len(f) for f in fields]}")
    device = planes[0].device
    for f in fields:
        for i, t in enumerate(f):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
                raise TypeError(f"planes must be contiguous float32 on {device}, got {t.dtype} on {t.device} "
                                f"(contiguous: {t.is_contiguous()})")
            least = (3, 1) if i % 6 in TIME_PLANES else (2, 2)
            if t.dim() != 3 or t.shape[2] % 4 or t.shape[0] < least[0] or t.shape[1] < least[1]:
                raise ValueError(f"plane {i} of shape {tuple(t.shape)}: expected (h, w, M), M a multiple of 4, at "
                                 f"least {least[0]} rows and {least[1]} columns")
    return planes


class RegPlaneStruct(ctypes.Structure):
    """`struct RegPlane` of `csrc/kplanes.cu`."""

    _fields_ = [
        ("plane", ctypes.c_void_p),
        ("grad", ctypes.c_void_p),
        ("h", ctypes.c_int32),
        ("row4", ctypes.c_int32),
        ("m4", ctypes.c_int32),
        ("kind", ctypes.c_int32),
        ("block0", ctypes.c_int32),
        ("accumulate", ctypes.c_int32),
        ("w0", ctypes.c_double),
        ("w1", ctypes.c_double),
    ]


class PlaneRegStruct(ctypes.Structure):
    """`struct PlaneReg` of `csrc/kplanes.cu`, passed by value."""

    _fields_ = [("n_planes", ctypes.c_int32), ("n_blocks", ctypes.c_int32), ("p", RegPlaneStruct * MAX_REG_PLANES)]


def _reg_struct(planes: Sequence[torch.Tensor], terms: Sequence[tuple], grads=None, accumulate=None) -> PlaneRegStruct:
    """The kernels' table: per plane its pointers, shape, kind, weights and
    first block (a thread a float4 of a row and a strip of REG_STRIP rows)."""
    r = PlaneRegStruct(n_planes=len(planes))
    block = 0
    for i, (t, (kind, w0, w1)) in enumerate(zip(planes, terms)):
        h, w, m = t.shape
        e = r.p[i]
        e.plane, e.h, e.row4, e.m4, e.kind, e.w0, e.w1 = t.data_ptr(), h, w * m // 4, m // 4, kind, w0, w1
        e.block0 = block
        if grads is not None:
            e.grad, e.accumulate = grads[i].data_ptr(), int(accumulate[i])
        block += -(-(e.row4 * -(-h // REG_STRIP)) // REG_THREADS)
    r.n_blocks = block
    return r


def _reg_fn(name: str):
    fn = getattr(load_library("kplanes").lib, name)
    if fn.argtypes is None:
        # r; partial and out (forward) or the cotangent (backward); stream.
        fn.argtypes = [PlaneRegStruct] + [ctypes.c_void_p] * (3 if name == "plane_reg_fwd" else 2)
        fn.restype = ctypes.c_int
    return fn


def _reg_call(name: str, planes, *pointers) -> None:
    device = planes[0].device
    with torch.cuda.device(device):
        err = _reg_fn(name)(*pointers, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed over {len(planes)} planes: cudaError {err}")


def _launch_reg_fwd(planes: Sequence[torch.Tensor], terms: Sequence[tuple]) -> torch.Tensor:
    """The forward's two launches → the weighted sum, a float32 scalar."""
    r = _reg_struct(planes, terms)
    partial = torch.empty(r.n_blocks, dtype=torch.float64, device=planes[0].device)
    out = torch.empty((), dtype=torch.float32, device=planes[0].device)
    _reg_call("plane_reg_fwd", planes, r, partial.data_ptr(), out.data_ptr())
    launches["reg_fwd"] += 2
    profiling.gauge("kplanes.reg_entries", sum(t.numel() for t in planes))
    return out


def _launch_reg_bwd(planes: Sequence[torch.Tensor], terms: Sequence[tuple], grad: torch.Tensor) -> list:
    """The backward's launch → per plane its gradient, or None where the
    launch added it into the plane's own `.grad` (`fli.grad_in_place`)."""
    if grad.dtype != torch.float32 or grad.numel() != 1 or grad.device != planes[0].device:
        raise ValueError(f"expected one float32 cotangent on {planes[0].device}, got {tuple(grad.shape)} {grad.dtype}")
    in_place = [fli.grad_in_place(t) for t in planes]
    buffers = [t.grad if own else torch.empty_like(t) for t, own in zip(planes, in_place)]
    _reg_call("plane_reg_bwd", planes, _reg_struct(planes, terms, buffers, in_place), grad.contiguous().data_ptr())
    launches["reg_bwd"] += 1
    profiling.gauge("kplanes.reg_entries", sum(t.numel() for t in planes))
    return [None if own else b for b, own in zip(buffers, in_place)]


class PlaneRegKernel(torch.autograd.Function):
    """The regularisers on their CUDA kernels: two launches forward, one
    backward; the forward saves the planes. Inside `fli.grads_in_place()`
    the backward adds a plane's gradient into its `.grad` where that is
    there and returns None for it."""

    @staticmethod
    def forward(ctx, terms, *planes):
        ctx.terms = terms
        ctx.save_for_backward(*planes)
        return _launch_reg_fwd(planes, terms)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return (None, *_launch_reg_bwd(ctx.saved_tensors, ctx.terms, grad))


def plane_regularization(fields: Sequence[Sequence[torch.Tensor]], weights: Sequence[Sequence[float]]) -> torch.Tensor:
    """The weighted plane regularisers of `fields` (each a plane field's
    planes, scale-major, six a scale in `PLANES`' order, (h, w, M) float32
    contiguous) with per field (tv, smoothness, l1) weights → one float32
    scalar, differentiable in the planes: Σ over fields of tv · Σ plane TV
    + smoothness · Σ time smoothness + l1 · Σ mean |1 − P| (the terms of
    `reg_terms`). CUDA tensors only, through the kernels; a CPU model takes
    the plain formulas (`models/kplanes.py::plane_regularizers`)."""
    planes = _check_reg(fields, weights)
    if planes[0].device.type != "cuda":
        raise ValueError(f"plane_regularization runs on cuda tensors, not {planes[0].device}")
    if any(t.data_ptr() % 16 for t in planes):
        raise ValueError("the regularisers' kernels read planes 16-byte aligned")
    return PlaneRegKernel.apply(tuple(reg_terms(fields, weights)), *planes)
