"""The bwd field lookup kernel's share of its roofline in the training step,
in %: the least time of the profiled check step's bwd lookups
(`hrfbench/counts/field_interp_bwd.py`, counted on the samples each call
serves) over that step's `field_bwd_kernel` time summed from the trace."""
from hrfbench import harness


def read(record):
    if "check_profile" not in record or "field_interp_bwd_least" not in record:
        return None
    kernel_s = harness.kernel_seconds(record["check_profile"], "field_bwd_kernel")
    return 100.0 * record["field_interp_bwd_least"][0] / kernel_s if kernel_s > 0 else None
