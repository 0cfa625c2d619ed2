"""Fused interpolating lookup: `out[p, f, n] = Σ_c w[p, c, n] · tables[p, f, idx[p, c, n]]`.

Counterpart of `humanrf_tpu/ops/fused_interp.py` (forward only). The TPU
kernel there builds bf16 one-hot rows in VMEM and contracts them on the MXU;
here the contract is computed directly by the hand-written CUDA kernel
`humanrf_torch/csrc/fused_interp.cu` (gather plus weighted sum, fp32), whose
source note says what bounds it and how the design answers. As with the
one-hot rows, a corner whose index lies outside [0, T) contributes nothing.

`fused_interp` launches that kernel for CUDA tensors and takes the plain
PyTorch version, `fused_interp_plain`, only for CPU tensors. There is no
fallback: a CUDA call that cannot launch raises. No gradients yet: the CUDA
path refuses tables that require grad under grad mode.
"""
from __future__ import annotations

import ctypes

import torch

from humanrf_torch.ops.cuda_build import load_library

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


def fused_interp_plain(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gather plus weighted sum in PyTorch (the contract, fp32), summed over
    c = 0..C-1 in order like the kernel; one (P, F, N) gather per corner."""
    P, F, T = tables.shape
    _, C, N = idx.shape
    in_table = (idx >= 0) & (idx < T)
    idx = torch.where(in_table, idx, 0).long()
    w = torch.where(in_table, w, 0.0)
    out = torch.zeros((P, F, N), dtype=torch.float32, device=tables.device)
    for c in range(C):
        gathered = torch.gather(tables, 2, idx[:, c, None, :].expand(P, F, N))
        out = out + gathered * w[:, c, None, :]
    return out


def _kernel():
    built = load_library("fused_interp")
    fn = built.lib.fused_interp_fwd
    if fn.argtypes is None:
        # tables, idx, w, out; P, C, F; T, N; stream.
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    if tables.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("fused_interp has no backward kernel yet; call it under torch.no_grad()")
    if not (tables.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_interp's CUDA kernel needs contiguous tables, idx and w")
    P, F, T = tables.shape
    _, C, N = idx.shape
    fn = _kernel()
    out = torch.empty((P, F, N), dtype=torch.float32, device=tables.device)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = fn(tables.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), P, C, F, T, N, stream)
    if err != 0:
        # 1 (invalid value): the kernel takes 1..8 corners and at most 65,535 pairs.
        raise RuntimeError(f"fused_interp_fwd launch failed at P={P}, C={C}, F={F}, T={T}, N={N}: cudaError {err}")
    launches += 1
    return out


def fused_interp(tables: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """tables (P, F, T) f32, idx (P, C, N) i32, w (P, C, N) f32 → (P, F, N) f32.

    CUDA tensors go through the CUDA kernel, CPU tensors through
    `fused_interp_plain`; anything else raises.
    """
    _check(tables, idx, w)
    if tables.device.type == "cuda":
        return _launch(tables, idx, w)
    if tables.device.type == "cpu":
        return fused_interp_plain(tables, idx, w)
    raise ValueError(f"fused_interp runs on cuda or cpu tensors, not {tables.device}")
