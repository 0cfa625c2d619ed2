"""The forward field lookup kernel's share of its roofline in the render
function, in %: the least time of the profiled view's lookups
(`hrfbench/counts/field_interp_fwd.py`) over that view's `field_fwd_kernel`
time summed from the trace."""
from hrfbench import harness


def read(record):
    if "profile" not in record or "field_interp_fwd_least" not in record:
        return None
    kernel_s = harness.kernel_seconds(record["profile"], "field_fwd_kernel")
    return 100.0 * record["field_interp_fwd_least"][0] / kernel_s if kernel_s > 0 else None
