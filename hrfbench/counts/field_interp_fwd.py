"""The forward lookup's work, in float32, for the calls of a work log.

A call serves n samples: it reads each sample's (x, y, z, t) once (16 B),
writes its P·F features once (4 B each), and reads each (pair, row) entry of
the table that its samples touch once (F · 4 B). Each feature sums C
corners: a multiply and an add per corner. The corner math is left out.
"""
from __future__ import annotations


def count(calls) -> tuple:
    """→ (operations, bytes) of the lookups in `calls` (the log's "grid" and "vector" entries)."""
    ops = nbytes = 0
    for c in calls:
        if c.get("kind") not in ("grid", "vector"):
            continue
        ops += 2 * c["n"] * c["P"] * c["C"] * c["F"]
        nbytes += 16 * c["n"] + 4 * c["n"] * c["P"] * c["F"] + 4 * c["rows"] * c["F"]
    return ops, nbytes


PRECISION = "fp32"
