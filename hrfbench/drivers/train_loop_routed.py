"""The closed training loop of `train_loop`, checked against the reference
with its field routed per segment (`hrfbench/reference/routed.py`): for a
configuration of many segments, beside whose program the masked reference's
lookups over every segment and sample would not fit on the card. Its
numbers are `train_loop`'s, split by the leaves the check steps reached,
with two more for those they did not (`routed.train_numbers`)."""
from __future__ import annotations

from hrfbench.drivers import train_loop
from hrfbench.reference import routed


def run(ctx) -> dict:
    """→ the run's record (see `hrfbench/run.py`)."""
    with routed.installed():
        return train_loop.run(ctx)
