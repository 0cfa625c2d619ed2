"""The 95th percentile, in ms, of the intervals between CUDA events recorded
on the stream at each training step's start: a step that waits on the host
counts its wait."""
import numpy as np


def read(record):
    return float(np.percentile(record["step_ms"], 95)) if record.get("step_ms") else None
