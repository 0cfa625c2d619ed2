"""Useful work of the render function: its valid rays (× Kf) over the rays
(× Kf) of the window's batches, in %."""


def read(record):
    return 100.0 * record["slot_fill"] if "slot_fill" in record else None
