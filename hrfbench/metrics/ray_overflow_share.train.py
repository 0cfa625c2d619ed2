"""The share of the valid rays that the dense sampler's budgets left out of
the loss, in %: the train step's device counters `sampler.rays_overflowed`
over `sampler.rays_valid`, read once after the run.

The counters are not windowed: they hold every step of the process, the
check, warm-up and profiled steps too (at most 4% of a run's steps). None
where the program keeps no such counters."""


def read(record):
    try:
        from humanrf_torch.utils.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    counters = snapshot()["counters"]
    valid = counters.get("sampler.rays_valid", 0)
    return 100.0 * counters["sampler.rays_overflowed"] / valid if valid else None
