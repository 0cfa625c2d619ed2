"""The fwd field lookup kernel's share of its roofline in the training step,
in %: the least time of the profiled check step's fwd lookups
(`hrfbench/counts/field_interp_fwd.py`, counted on the samples each call
serves) over that step's `field_fwd_kernel` time summed from the trace."""
from hrfbench import harness


def read(record):
    if "check_profile" not in record or "field_interp_fwd_least" not in record:
        return None
    kernel_s = harness.kernel_seconds(record["check_profile"], "field_fwd_kernel")
    return 100.0 * record["field_interp_fwd_least"][0] / kernel_s if kernel_s > 0 else None
