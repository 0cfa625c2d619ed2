"""The plane query's backward work, in float32, for the differentiated
calls of a work log: the forward's count (`kplanes_fwd.py`) with the
features' cotangents read in place of the features written. Its gradients'
adds into the touched texels are taken at the forward's operations and the
texels' one read: a lower bound, so the share of it reads low, not high."""
from __future__ import annotations

from hrfbench.counts.kplanes_fwd import ops_per_sample


def count(calls) -> tuple:
    """→ (operations, bytes) of the backward of the plane queries in `calls` that took a gradient."""
    ops = nbytes = 0
    for c in calls:
        if c.get("kind") != "planes" or not c["grad"]:
            continue
        ops += c["n"] * ops_per_sample(c)
        nbytes += 16 * c["n"] + 4 * c["n"] * c["S"] * c["M"] + 4 * c["texels"] * c["M"]
    return ops, nbytes


PRECISION = "fp32"
