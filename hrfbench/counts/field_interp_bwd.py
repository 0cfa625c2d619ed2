"""The backward lookup's work, in float32, for the differentiated calls of a work log.

A call reads each served sample's coordinates (16 B) and its P·F output
gradients (4 B each) once, and adds a weighted gradient into each touched
(pair, row) entry of the table, which it writes once (F · 4 B). Each corner
of each feature is a multiply and an add.
"""
from __future__ import annotations


def count(calls) -> tuple:
    """→ (operations, bytes) of the backward of the calls in `calls` that took a gradient."""
    ops = nbytes = 0
    for c in calls:
        if c.get("kind") not in ("grid", "vector") or not c["grad"]:
            continue
        ops += 2 * c["n"] * c["P"] * c["C"] * c["F"]
        nbytes += 16 * c["n"] + 4 * c["n"] * c["P"] * c["F"] + 4 * c["rows"] * c["F"]
    return ops, nbytes


PRECISION = "fp32"
