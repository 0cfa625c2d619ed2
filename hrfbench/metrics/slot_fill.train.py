"""Useful work of the sampler: the samples the window's steps rendered
(`aux["num_samples"]`, summed on the device) over the sample slots they ran
(the dense sampler's `sample_budget`, the proposal sampler's rays × Kf), in %."""


def read(record):
    return 100.0 * record["slot_fill"] if "slot_fill" in record else None
