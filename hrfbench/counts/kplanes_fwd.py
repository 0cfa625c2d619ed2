"""The plane query's forward work, in float32, for the calls of a work log.

A call ("planes" entry) serves n samples over S scales of six planes of M
channels. For each served sample, scale and plane it sums 4 taps of M
channels (a multiply and an add each) and multiplies the plane's M values
into the product; it reads each sample's coordinates once (16 B), writes
its S·M features once (4 B each), and reads each plane texel that the taps
touch once (M · 4 B). The tap math is left out.
"""
from __future__ import annotations


def ops_per_sample(c: dict) -> int:
    """4 taps × M multiply-adds plus the product's M multiplies, per scale and plane."""
    return c["S"] * 6 * (2 * 4 * c["M"] + c["M"])


def count(calls) -> tuple:
    """→ (operations, bytes) of the plane queries in `calls`."""
    ops = nbytes = 0
    for c in calls:
        if c.get("kind") != "planes":
            continue
        ops += c["n"] * ops_per_sample(c)
        nbytes += 16 * c["n"] + 4 * c["n"] * c["S"] * c["M"] + 4 * c["texels"] * c["M"]
    return ops, nbytes


PRECISION = "fp32"
