"""Published peaks of one NVIDIA H100 SXM (the data sheet; dense, at the
700 W limit), and the least time of a piece of work.

The least time is the larger of the operations over the peak of the
precision they are stated in and the bytes over the memory bandwidth; each
count says its precision, and `least_time` says which of the two binds.
"""
from __future__ import annotations

OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_time(ops: float, nbytes: float, precision: str) -> tuple:
    """→ (seconds, "ops" or "bytes": the bound that binds)."""
    by_ops, by_bytes = ops / OPS_PER_S[precision], nbytes / HBM_BYTES_PER_S
    return (by_ops, "ops") if by_ops >= by_bytes else (by_bytes, "bytes")


def least_time_mixed(ops_by_precision: dict, nbytes: float) -> tuple:
    """Work whose operations come in several precisions: each share at its own peak."""
    by_ops = sum(ops / OPS_PER_S[p] for p, ops in ops_by_precision.items())
    by_bytes = nbytes / HBM_BYTES_PER_S
    return (by_ops, "ops") if by_ops >= by_bytes else (by_bytes, "bytes")
