"""The readers of the optimizer's time (`hrfbench/metrics/{optimizer_share,
adamw_roofline}.train.py`) on a hand-built recorder: the window's calls of
the train step, their `train.optimizer_ms` against their `graph.device_ms`
and the count `train.optimizer_params`; None where the program times no
optimizer (a program before these spans), keeps no count, or its ring
dropped the window's spans."""
import pytest

from hrfbench import harness
from hrfbench.counts.peaks import HBM_BYTES_PER_S
from humanrf_torch.utils import profiling

MS = 1_000_000  # ns
PARAMS = 676_000_000


class Clock:
    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


def _read(name, record):
    return harness.load_module("metrics", name).read(record)


def _fill(rec, calls: int, optimizer: bool = True):
    """`calls` train-step calls of 10 ms, 8 ms on the device, of which call i's
    optimizer takes 4 + i ms; a render call between."""
    for i in range(1, calls + 1):
        with rec.span("graph.call", ("the train step", i)):
            rec.clock.now += 10 * MS
        rec.add_device_ms("graph.device_ms", ("the train step", i), 8.0 + i)
        if optimizer:
            rec.add_device_ms("train.optimizer_ms", ("the train step", i), 4.0 + i)
        with rec.span("graph.call", ("the render function", i)):
            pass
        rec.add_device_ms("graph.device_ms", ("the render function", i), 1.0)


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder(clock=Clock())
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_the_readers_take_the_window_calls_times(recorder):
    _fill(recorder, 5)
    recorder.gauge("train.optimizer_params", PARAMS)
    record = {"steps": 3, "window_s": 0.03}  # calls 3, 4, 5
    assert _read("optimizer_share.train", record) == pytest.approx(100 * (7 + 8 + 9) / (11 + 12 + 13))
    least_s = 28 * PARAMS / HBM_BYTES_PER_S
    assert _read("adamw_roofline.train", record) == pytest.approx(100 * least_s / 8e-3)


def test_none_without_the_optimizers_times_or_count(recorder):
    record = {"steps": 3, "window_s": 0.03}
    for name in ("optimizer_share.train", "adamw_roofline.train"):
        assert _read(name, record) is None, name
    _fill(recorder, 5, optimizer=False)  # a program that times the replays alone
    recorder.gauge("train.optimizer_params", PARAMS)
    for name in ("optimizer_share.train", "adamw_roofline.train"):
        assert _read(name, record) is None, name


def test_none_without_the_parameter_count_or_with_too_few_calls(recorder):
    _fill(recorder, 5)
    assert _read("optimizer_share.train", {"steps": 5, "window_s": 0.05}) is not None
    assert _read("adamw_roofline.train", {"steps": 5, "window_s": 0.05}) is None
    assert _read("optimizer_share.train", {"steps": 6, "window_s": 0.06}) is None


def test_none_when_the_ring_dropped_the_windows_spans(monkeypatch):
    rec = profiling.Recorder(ring_size=5, clock=Clock())
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _fill(rec, 5)
    rec.gauge("train.optimizer_params", PARAMS)
    assert _read("optimizer_share.train", {"steps": 3, "window_s": 0.03}) is None
    assert _read("adamw_roofline.train", {"steps": 3, "window_s": 0.03}) is None
    assert _read("optimizer_share.train", {"steps": 1, "window_s": 0.01}) is not None
