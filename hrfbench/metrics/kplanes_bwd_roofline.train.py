"""The plane query's bwd kernel's share of its roofline in the training
step, in %: the least time of the profiled check step's bwd plane queries
(`hrfbench/counts/kplanes_bwd.py`, counted on the samples each query
serves) over that step's `kplanes_bwd_kernel` time summed from the trace.
None where the run has no such count or kernel (a program without K-Planes)."""
from hrfbench import harness


def read(record):
    if "check_profile" not in record or "kplanes_bwd_least" not in record:
        return None
    kernel_s = harness.kernel_seconds(record["check_profile"], "kplanes_bwd_kernel")
    return 100.0 * record["kplanes_bwd_least"][0] / kernel_s if kernel_s > 0 else None
