"""A render's least time on the chip: its MLPs (bfloat16) and forward field
lookups (float32), counted from the valid samples of its work log."""
from __future__ import annotations

from hrfbench.counts import field_interp_fwd, mlp
from hrfbench.counts.peaks import least_time_mixed


def count(log, model: dict) -> dict:
    """→ {"ops": {precision: operations}, "bytes", "least_s", "binds"}."""
    fwd_ops, fwd_bytes = field_interp_fwd.count(log)
    ops = {"bf16": mlp.count(log, model), "fp32": fwd_ops}
    least, binds = least_time_mixed(ops, fwd_bytes)
    return {"ops": ops, "bytes": fwd_bytes, "least_s": least, "binds": binds}
