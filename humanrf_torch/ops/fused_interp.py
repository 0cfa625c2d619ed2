"""Fused interpolating lookup: `out[p, f, n] = Σ_c w[p, c, n] · tables[p, f, idx[p, c, n]]`.

Counterpart of `humanrf_tpu/ops/fused_interp.py`, forward and backward. The
TPU kernels there build bf16 one-hot rows in VMEM and contract them on the
MXU; here the hand-written CUDA kernels of `humanrf_torch/csrc/fused_interp.cu`
compute the contract directly in fp32: the forward gathers and sums, the
backward scatter-adds `g · w` into the tables through a shared-memory slab.
Their source note says what bounds them and how the design answers. As with
the one-hot rows, a corner whose index lies outside [0, T) contributes
nothing and gets no gradient.

`fused_interp` is differentiable in `tables` only, as the JAX `custom_vjp` is:
sample positions carry no parameter gradient, so `idx` and `w` get none. For
CUDA tensors it runs `FusedInterpKernel` (both directions launch a kernel);
for CPU tensors `PlainFusedInterp`, whose directions are the plain PyTorch
versions `fused_interp_plain` and `fused_interp_bwd_plain`. There is no
fallback: a CUDA call that cannot launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from humanrf_torch.ops.cuda_build import load_library

# Kernel launches since the last reset, per direction (each wrapper adds one
# where it launches its kernel).
launches = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    launches["fwd"] = launches["bwd"] = 0


def _check(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor):
    if tables.dim() != 3 or idx.dim() != 3 or w.dim() != 3:
        raise ValueError(
            f"expected tables (P,F,T), idx (P,C,N), w (P,C,N); got {tuple(tables.shape)}, "
            f"{tuple(idx.shape)}, {tuple(w.shape)}"
        )
    if idx.shape != w.shape or idx.shape[0] != tables.shape[0]:
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, idx {tuple(idx.shape)}, w {tuple(w.shape)}")
    if tables.dtype != torch.float32 or idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"expected float32/int32/float32, got {tables.dtype}/{idx.dtype}/{w.dtype}")
    if not (tables.device == idx.device == w.device):
        raise ValueError(f"tensors on different devices: {tables.device}, {idx.device}, {w.device}")


def _in_table(idx: torch.Tensor, w: torch.Tensor, table_size: int):
    """Out-of-table corners → index 0 with weight 0."""
    in_table = (idx >= 0) & (idx < table_size)
    return torch.where(in_table, idx, 0).long(), torch.where(in_table, w, 0.0)


def fused_interp_plain(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gather plus weighted sum in PyTorch (the contract, fp32), summed over
    c = 0..C-1 in order like the kernel; one (P, F, N) gather per corner."""
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
    (P, F, T) tensor of g's type (fp32 on the main path; fp64 sums a
    reference), one corner at a time. An out-of-table corner adds 0 at index
    0, which leaves the sum as it is."""
    P, F, N = g.shape
    idx, w = _in_table(idx, w, table_size)
    dtab = torch.zeros((P, F, table_size), dtype=g.dtype, device=g.device)
    for c in range(idx.shape[1]):
        dtab.scatter_add_(2, idx[:, c, None, :].expand(P, F, N), g * w[:, c, None, :])
    return dtab


def _kernel(name: str):
    fn = getattr(load_library("fused_interp").lib, name)
    if fn.argtypes is None:
        # in0, idx, w, out; P, C, F; T, N; stream.
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _run(name: str, first: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, out: torch.Tensor, F: int, T: int):
    if not (first.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_interp's CUDA kernels need contiguous inputs")
    P, C, N = idx.shape
    fn = _kernel(name)
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = fn(first.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), P, C, F, T, N, stream)
    if err != 0:
        # 1 (invalid value): the kernels take 1..8 corners and at most 65,535 pairs.
        raise RuntimeError(f"{name} launch failed at P={P}, C={C}, F={F}, T={T}, N={N}: cudaError {err}")


def _launch_fwd(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    P, F, T = tables.shape
    out = torch.empty((P, F, idx.shape[2]), dtype=torch.float32, device=tables.device)
    _run("fused_interp_fwd", tables, idx, w, out, F, T)
    launches["fwd"] += 1
    return out


def _launch_bwd(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, table_size: int) -> torch.Tensor:
    P, F, N = g.shape
    if g.dtype != torch.float32 or (P, N) != (idx.shape[0], idx.shape[2]) or g.device != idx.device:
        raise ValueError(f"expected g (P,F,N) float32 beside idx {tuple(idx.shape)}, got {tuple(g.shape)} {g.dtype}")
    dtab = torch.zeros((P, F, table_size), dtype=torch.float32, device=g.device)
    _run("fused_interp_bwd", g, idx, w, dtab, F, table_size)
    launches["bwd"] += 1
    return dtab


class FusedInterpKernel(torch.autograd.Function):
    """Both directions on the CUDA kernels. The forward saves `idx` and `w`,
    the residuals of the JAX `_fused_interp_fwd`."""

    @staticmethod
    def forward(ctx, tables, idx, w):
        ctx.save_for_backward(idx, w)
        ctx.table_size = tables.shape[2]
        return _launch_fwd(tables, idx, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        return _launch_bwd(g.contiguous(), idx, w, ctx.table_size), None, None


class PlainFusedInterp(torch.autograd.Function):
    """Both directions in plain PyTorch: `fused_interp_plain` and
    `fused_interp_bwd_plain`."""

    @staticmethod
    def forward(ctx, tables, idx, w):
        ctx.save_for_backward(idx, w)
        ctx.table_size = tables.shape[2]
        return fused_interp_plain(tables, idx, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        return fused_interp_bwd_plain(g.contiguous(), idx, w, ctx.table_size), None, None


def fused_interp(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """tables (P, F, T) f32, idx (P, C, N) i32, w (P, C, N) f32 → (P, F, N) f32,
    differentiable in `tables`.

    CUDA tensors go through the CUDA kernels, CPU tensors through the plain
    versions; anything else raises.
    """
    _check(tables, idx, w)
    if tables.device.type == "cuda":
        return FusedInterpKernel.apply(tables, idx, w)
    if tables.device.type == "cpu":
        return PlainFusedInterp.apply(tables, idx, w)
    raise ValueError(f"fused_interp runs on cuda or cpu tensors, not {tables.device}")
