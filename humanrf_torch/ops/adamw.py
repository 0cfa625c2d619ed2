"""AdamW's step over every parameter tensor in two kinds of launch: the
hand-written CUDA kernels of `humanrf_torch/csrc/adamw.cu`, which
`train/trainer.py::AdamW` runs on CUDA tensors (CPU tensors keep its plain
body, which the kernels equal bit for bit).

- `finite(launches)`: whether every gradient is finite, as a bool on the
  device (`adamw_finite`: 4 B a parameter read, no bool tensor written);
- `update(launches, finite, constants)`: where that flag is true, one pass
  that reads the parameter, its gradient and both moments and writes the
  parameter and both moments (`adamw_update`: 28 B a parameter).

Each launch takes a table of at most `MAX_TENSORS` tensors, passed by value
(`AdamWTable`); `plan` splits a longer list of tensors into launches, and
`tables` builds them from the tensors as they are at the call, so a moment
tensor swapped between calls (the FSDP step's `full_state`) is found where
it is. Under CUDA graph capture the pointers are baked into the graph, and
every replay finds the same buffers.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch

from humanrf_torch.ops.cuda_build import load_library

MAX_TENSORS = 256       # kMaxTensors of csrc/adamw.cu
CHUNK = 2048            # kChunk: the elements a block takes at a time
PARAM_LIMIT = 32_764    # the bytes a kernel's parameters may hold on Hopper (CUDA 12.1 and later)

# Kernel launches since the last reset: "finite" and "update", one each per
# launch planned (a CUDA graph's replays add what its capture counted:
# `train/graphs.py`).
launches = {"finite": 0, "update": 0}


def reset_launches() -> None:
    launches["finite"] = launches["update"] = 0


class AdamWTensor(ctypes.Structure):
    """`struct AdamWTensor` of `csrc/adamw.cu`."""

    _fields_ = [
        ("p", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("chunk0", ctypes.c_longlong),
    ]


class AdamWTable(ctypes.Structure):
    """`struct AdamWTable` of `csrc/adamw.cu`, passed by value."""

    _fields_ = [
        ("n_tensors", ctypes.c_int32),
        ("n_chunks", ctypes.c_longlong),
        ("t", AdamWTensor * MAX_TENSORS),
    ]


class AdamWConstants(ctypes.Structure):
    """`struct AdamWConstants` of `csrc/adamw.cu`, passed by value: the
    Python constants as fp32 (as PyTorch rounds a Python float for a float32
    tensor) and the 0-dim device tensors of the step size and the bias
    corrections."""

    _fields_ = [
        ("one_minus_b1", ctypes.c_float),
        ("b1", ctypes.c_float),
        ("one_minus_b2", ctypes.c_float),
        ("b2", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("wd", ctypes.c_float),
        ("step_size", ctypes.c_void_p),
        ("bc1", ctypes.c_void_p),
        ("bc2", ctypes.c_void_p),
    ]


class Launch(NamedTuple):
    """One launch's tensors (indices into the caller's list), the first
    chunk of each, and its chunks in all."""

    tensors: tuple
    chunk0: tuple
    n_chunks: int


def plan(numels: Sequence[int]) -> List[Launch]:
    """The launches over tensors of `numels` elements: at most `MAX_TENSORS`
    a launch, in order, tensors without elements left out; a tensor of n
    elements takes ceil(n / CHUNK) chunks, numbered across its launch."""
    out, tensors, chunk0, chunks = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(tensors) == MAX_TENSORS:
            out.append(Launch(tuple(tensors), tuple(chunk0), chunks))
            tensors, chunk0, chunks = [], [], 0
        tensors.append(i)
        chunk0.append(chunks)
        chunks += -(-n // CHUNK)
    if tensors:
        out.append(Launch(tuple(tensors), tuple(chunk0), chunks))
    return out


def _check(params, grads, mu, nu) -> None:
    device = params[0].device
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        for name, t in (("parameter", p), ("gradient", g), ("first moment", m), ("second moment", v)):
            if t is None and name == "gradient":
                continue
            if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() or t.numel() != p.numel():
                raise TypeError(f"AdamW's kernels take contiguous float32 tensors on {device}; tensor {i}'s {name} "
                                f"is {t.dtype}, {tuple(t.shape)}, contiguous {t.is_contiguous()}, on {t.device} "
                                f"(parameter {tuple(p.shape)})")


def tables(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]], mu: Sequence[torch.Tensor],
           nu: Sequence[torch.Tensor]) -> List[AdamWTable]:
    """The launches' tables over the tensors as they are now; a None
    gradient is a zero one. Raises unless every tensor is a contiguous
    float32 tensor of its parameter's size on the parameters' device."""
    _check(params, grads, mu, nu)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    out = []
    for launch in plan([p.numel() for p in params]):
        tab = AdamWTable(n_tensors=len(launch.tensors), n_chunks=launch.n_chunks)
        for k, (i, chunk0) in enumerate(zip(launch.tensors, launch.chunk0)):
            tab.t[k] = AdamWTensor(params[i].data_ptr(), ptr(grads[i]), mu[i].data_ptr(), nu[i].data_ptr(),
                                   params[i].numel(), chunk0)
        out.append(tab)
    return out


def _fn(name: str, argtypes):
    fn = getattr(load_library("adamw").lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _call(name: str, argtypes, device, tab: AdamWTable, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name, argtypes)(tab, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed over {tab.n_tensors} tensors, {tab.n_chunks} chunks: "
                           f"cudaError {err}")
    launches[name.removeprefix("adamw_")] += 1


def finite(tabs: Sequence[AdamWTable], device) -> torch.Tensor:
    """A 0-dim bool on `device`: whether every gradient of the tables is
    finite (a None gradient is)."""
    bad = torch.zeros((), dtype=torch.int32, device=device)
    for tab in tabs:
        _call("adamw_finite", [AdamWTable, ctypes.c_void_p, ctypes.c_void_p], device, tab, bad.data_ptr())
    return bad == 0


def update(tabs: Sequence[AdamWTable], flag: torch.Tensor, constants: AdamWConstants) -> None:
    """Where the 0-dim bool `flag` is true, every tensor of the tables takes
    one AdamW update in place; where it is false, nothing is touched."""
    argtypes = [AdamWTable, AdamWConstants, ctypes.c_void_p, ctypes.c_void_p]
    for tab in tabs:
        _call("adamw_update", argtypes, flag.device, tab, constants, flag.data_ptr())
