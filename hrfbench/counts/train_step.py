"""A training step's least time on the chip: its MLPs (bfloat16), both
directions of its field lookups and AdamW (float32), counted from the valid
samples and rays of its work log."""
from __future__ import annotations

from hrfbench.counts import adamw, field_interp_bwd, field_interp_fwd, mlp
from hrfbench.counts.peaks import least_time_mixed


def count(log, model: dict, num_params: int) -> dict:
    """→ {"ops": {precision: operations}, "bytes", "least_s", "binds"}."""
    fwd_ops, fwd_bytes = field_interp_fwd.count(log)
    bwd_ops, bwd_bytes = field_interp_bwd.count(log)
    opt_ops, opt_bytes = adamw.count(num_params)
    ops = {"bf16": mlp.count(log, model), "fp32": fwd_ops + bwd_ops + opt_ops}
    nbytes = fwd_bytes + bwd_bytes + opt_bytes
    least, binds = least_time_mixed(ops, nbytes)
    return {"ops": ops, "bytes": nbytes, "least_s": least, "binds": binds}
