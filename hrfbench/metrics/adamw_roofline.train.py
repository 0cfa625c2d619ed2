"""AdamW's share of its roofline in the training step, in %: the least time
of one update of every parameter (`hrfbench/counts/adamw.py`: 28 B a
parameter, the bytes bind) over the mean `train.optimizer_ms` of the
window's train-step calls (`optimizer_share.train`'s window). The parameters
are the program's gauge `train.optimizer_params`, what the process's
latest optimizer updates. None where the program keeps no such count or times."""
from hrfbench import harness
from hrfbench.counts import adamw
from hrfbench.counts.peaks import least_time


def read(record):
    try:
        from humanrf_torch.utils.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    num_params = snapshot()["counters"].get("train.optimizer_params")
    times = harness.load_module("metrics", "optimizer_share.train").window_times(record, "train.optimizer_ms")
    if not num_params or times is None:
        return None
    least_s, _ = least_time(*adamw.count(num_params), adamw.PRECISION)
    return 100.0 * least_s / (sum(times[0]) / len(times[0]) / 1e3)
