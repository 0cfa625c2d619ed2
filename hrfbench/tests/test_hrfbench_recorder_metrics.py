"""The readers of the program's spans and counters
(`hrfbench/metrics/{fetch_lock_wait_share,fetch_upload_share,
replacer_busy_share,step_device_share,ray_overflow_share}.train.py`) on a
hand-built record and recorder: the values the spans give, the window taken
as the last `steps` fetches and calls, and None where the ring dropped the
window's spans or the program recorded nothing."""
import pytest

from hrfbench import harness
from humanrf_torch.utils import profiling

SPAN_READERS = ("fetch_lock_wait_share.train", "fetch_upload_share.train", "replacer_busy_share.train",
                "step_device_share.train")
MS = 1_000_000  # ns


class Clock:
    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


def _read(name, record):
    return harness.load_module("metrics", name).read(record)


def _fill(rec, fetches: int):
    """`fetches` loop iterations of 10 ms each: a fetch of 4 ms (1 ms waiting
    for data_lock, 0.5 ms for grid_lock, a 2 ms grid upload on odd batches,
    0.25 ms staging), then a train-step call of 6 ms with 5 ms on the device,
    a render call between; a 3 ms image load every other iteration, the
    first one starting 1 ms before the loop."""
    clock = rec.clock
    with rec.span("loader.load", 0):
        clock.now += 2 * MS
    clock.now -= MS  # the load ran on another thread, 1 ms into the loop
    for i in range(1, fetches + 1):
        t = clock.now
        with rec.span("loader.fetch", i):
            with rec.span("loader.lock_wait"):
                clock.now += MS
            with rec.span("loader.lock_wait"):
                clock.now += MS // 2
            if i % 2:
                with rec.span("loader.grid_upload"):
                    clock.now += 2 * MS
            with rec.span("loader.stage"):
                clock.now += MS // 4
            clock.now = t + 4 * MS
        with rec.span("graph.call", ("the train step", i)):
            clock.now += 6 * MS
        rec.add_device_ms("graph.device_ms", ("the train step", i), 5.0)
        with rec.span("graph.call", ("the render function", i)):
            pass
        if i % 2 == 0:
            clock.now -= 4 * MS  # on the replacer thread, beside the step
            with rec.span("loader.load", i):
                with rec.span("loader.decode"):
                    clock.now += 3 * MS
            clock.now += MS
    with rec.span("loader.load", 99):  # after the window
        clock.now += 50 * MS


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder(clock=Clock())
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_the_readers_take_the_last_steps_fetches_and_calls(recorder):
    _fill(recorder, 6)  # batches 1, 2 before the window; 3-6 in it (two grid uploads)
    window_s = 0.045
    record = {"steps": 4, "window_s": window_s}
    assert _read("fetch_lock_wait_share.train", record) == pytest.approx(100 * 4 * 1.5e-3 / window_s)
    assert _read("fetch_upload_share.train", record) == pytest.approx(100 * (2 * 2e-3 + 4 * 0.25e-3) / window_s)
    # The window runs from batch 3's fetch (at 21 ms) to the end of call 6
    # (at 61 ms): the loads of batches 4 and 6, 3 ms each.
    assert _read("replacer_busy_share.train", record) == pytest.approx(100 * 6e-3 / window_s)
    assert _read("step_device_share.train", record) == pytest.approx(100 * 4 * 5e-3 / window_s)


def test_a_load_across_the_window_start_counts_only_its_part_inside(recorder):
    _fill(recorder, 2)
    # One window step (batch 2, from 11 ms to 21 ms): batch 2's load (17 to
    # 20 ms). Two steps (from 1 ms): the first load (0 to 2 ms) half inside.
    assert _read("replacer_busy_share.train", {"steps": 1, "window_s": 0.01}) == pytest.approx(30.0)
    assert _read("replacer_busy_share.train", {"steps": 2, "window_s": 0.02}) == pytest.approx(100 * 4e-3 / 0.02)


def test_none_when_the_ring_dropped_the_windows_spans(monkeypatch):
    rec = profiling.Recorder(ring_size=20, clock=Clock())
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _fill(rec, 6)
    snap = profiling.snapshot()
    assert snap["dropped"] > 0
    for name in SPAN_READERS:
        assert _read(name, {"steps": 4, "window_s": 0.04}) is None, name
        assert _read(name, {"steps": 1, "window_s": 0.01}) is not None, name


def test_none_when_the_program_recorded_nothing(recorder):
    for name in (*SPAN_READERS, "ray_overflow_share.train"):
        assert _read(name, {"steps": 4, "window_s": 0.04}) is None, name
    _fill(recorder, 6)
    assert _read("step_device_share.train", {"steps": 7, "window_s": 0.07}) is None  # fewer calls than steps


def test_ray_overflow_share_reads_the_sampler_counters(recorder):
    profiling.device_counter("sampler.rays_valid", "cpu").add_(800)
    profiling.device_counter("sampler.rays_overflowed", "cpu").add_(6)
    assert _read("ray_overflow_share.train", {"steps": 1, "window_s": 1.0}) == pytest.approx(0.75)
