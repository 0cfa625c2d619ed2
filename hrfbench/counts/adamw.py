"""AdamW's work over all parameters, in float32: it reads the parameter,
its gradient and both moments and writes the parameter and both moments
(7 · 4 B), with about a dozen operations, per parameter."""
from __future__ import annotations


def count(num_params: int) -> tuple:
    return 12 * num_params, 28 * num_params


PRECISION = "fp32"
