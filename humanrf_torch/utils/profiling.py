"""Profiling: a flight recorder of spans and counters, and profiler traces.

Counterpart of `humanrf_tpu/utils/profiling.py` over `torch.profiler`, with
one recorder the JAX package does not have.

**The recorder** (`RECORDER`, process-global, thread-safe, on by default):

- `span(name, id=None)`: a context manager around one piece of host work.
  Each span keeps its name; an `id` shared by the spans of one request (a
  fetch's batch number, an image load's pair index, a graphed call's
  `(step name, call number)`, the trainer's step): a span given none takes
  its parent's; its parent, the enclosing span on the same thread; its
  thread; start and end on `time.perf_counter_ns`. Spans go into one
  bounded ring (`RING_SIZE`); the oldest fall out of it, counted as
  dropped. While a `torch.profiler` is active on the span's thread, the span
  is also a CPU event of the trace (a cpu_op range: unlike
  `record_function`'s user annotations it puts no range on the device's
  rows, which would count as device work), on the timeline of the kernels.
- `count(name, n=1)`: a host counter.
- `gauge(name, n)`: a host count set to `n` (a size, such as what the
  latest build holds), where `count` adds up.
- `device_counter(name, device)`: a persistent int64 tensor that code on the
  device adds to in place; inside a captured CUDA graph the add replays with
  the graph, and nothing reads it back until `snapshot()`.
- `device_time(name, id, device)`: a CUDA event pair around device work,
  from a reused pool, resolved later by `query()` (never a sync) into
  milliseconds under `(name, id)`.
- `snapshot()`: one read of everything, with one device sync: the spans
  per name, each with its self time (its duration less what its children
  cover), the counters (host and device), the device times, and the drops.
- `enable(False)`: every span, count and device time is then one branch
  and records nothing (to measure what the recorder costs).

No span may be opened inside a captured graph's body: Python does not run
when the graph replays.

**Traces**: `Trace` records the CPU and, when a GPU is present, its CUDA
activity between `start()` and `stop()`, and writes it into its folder as
one Chrome-trace JSON file (`<host>_<pid>.<ms>.pt.trace.json`, the name that
PyTorch's TensorBoard plugin reads; chrome://tracing and Perfetto open it
too), and beside it `<host>_<pid>.<ms>.gaps.json`: the ten longest idle
gaps of the device, each labelled by `idle_gaps` with the recorder's span
the host was in.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import socket
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import torch

RING_SIZE = 1 << 18


class Span(NamedTuple):
    """One recorded span; `parent` is the parent's `seq`, -1 for a root;
    `annotated`: it was a CPU event of an active profiler's trace."""

    name: str
    id: Any
    seq: int
    parent: int
    thread: int
    start_ns: int
    end_ns: int
    annotated: bool
    self_ns: int


class _Null:
    """The span of a disabled recorder."""

    duration_ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "name", "id", "seq", "parent", "stack", "fn", "start_ns", "duration_ns")

    def __init__(self, rec: "Recorder", name: str, id):
        self.rec, self.name, self.id = rec, name, id
        self.duration_ns = 0

    def __enter__(self):
        rec = self.rec
        stack = rec._local.__dict__.setdefault("stack", [])
        if stack:
            top = stack[-1]
            self.parent = top.seq
            if self.id is None:
                self.id = top.id
        else:
            self.parent = -1
        self.seq = next(rec._seq)
        self.stack = stack
        stack.append(self)
        self.fn = None
        if torch._C._autograd._profiler_enabled():
            self.fn = torch._C._profiler._RecordFunctionFast(self.name)
            self.fn.__enter__()
        self.start_ns = rec.clock()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        end = rec.clock()
        if self.fn is not None:
            self.fn.__exit__(None, None, None)
        self.stack.pop()
        self.duration_ns = end - self.start_ns
        rec._append((self.name, self.id, self.seq, self.parent, threading.get_ident(), self.start_ns, end,
                     self.fn is not None))
        return False


class _DeviceTime:
    __slots__ = ("rec", "key", "stream", "pair")

    def __init__(self, rec: "Recorder", key, device):
        self.rec, self.key = rec, key
        self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        free = self.rec._free_events
        self.pair = free.pop() if free else (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.pair[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        self.pair[1].record(self.stream)
        self.rec._pending_events.append((self.key, self.pair, self.stream.device))
        self.rec._poll_events()
        return False


class Recorder:
    """The spans, counters and device times of one process (see the module
    docstring); `clock` is the span clock (a test substitutes its own)."""

    def __init__(self, ring_size: int = RING_SIZE, clock=time.perf_counter_ns):
        self.clock = clock
        self.enabled = True
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = itertools.count()
        self._ring = collections.deque(maxlen=ring_size)
        self._ended = 0
        self._names = set()
        self._counters: Dict[str, int] = {}
        self._device_counters: Dict[tuple, torch.Tensor] = {}
        self._device_ms = collections.deque(maxlen=ring_size)
        self._free_events: List[tuple] = []
        self._pending_events = collections.deque()

    def span(self, name: str, id=None):
        if not self.enabled:
            return _NULL
        return _Span(self, name, id)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, n: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = n

    def device_counter(self, name: str, device) -> torch.Tensor:
        device = torch.device(device)
        with self._lock:
            key = (name, device)
            if key not in self._device_counters:
                self._device_counters[key] = torch.zeros((), dtype=torch.int64, device=device)
            return self._device_counters[key]

    def device_time(self, name: str, id, device):
        device = torch.device(device)
        if not self.enabled or device.type != "cuda":
            return _NULL
        return _DeviceTime(self, (name, id), device)

    def add_device_ms(self, name: str, id, ms: float) -> None:
        """Keep `ms` of device time under `(name, id)` (what `device_time` resolves into)."""
        self._device_ms.append((name, id, ms))

    def _append(self, record: tuple) -> None:
        with self._lock:
            self._ring.append(record)
            self._ended += 1
            self._names.add(record[0])

    def _poll_events(self) -> None:
        """Resolve the event pairs whose work has run, oldest first; never waits."""
        pending = self._pending_events
        while pending and pending[0][1][1].query():
            (name, id), pair, _ = pending.popleft()
            self.add_device_ms(name, id, pair[0].elapsed_time(pair[1]))
            self._free_events.append(pair)

    def snapshot(self) -> dict:
        """→ {"spans": {name: [Span, ...] in the order they ended}, "counters":
        {name: int} (host counters and device counters summed over devices),
        "device_ms": {name: {id: ms}}, "dropped": spans that fell out of the
        ring, "since_ns": the end of the oldest span kept (spans that ended
        before it may have been dropped)}. Synchronizes each device that
        holds a counter or pending device times once."""
        devices = {d for _, d in self._device_counters} | {p[2] for p in self._pending_events}
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self._poll_events()
        with self._lock:
            ring, ended = list(self._ring), self._ended
            counters = dict(self._counters)
            device_counters = list(self._device_counters.items())
        for (name, _), t in device_counters:
            counters[name] = counters.get(name, 0) + int(t)
        children: Dict[int, int] = {}
        for r in ring:
            if r[3] >= 0:
                children[r[3]] = children.get(r[3], 0) + r[6] - r[5]
        spans: Dict[str, List[Span]] = {}
        for r in ring:
            spans.setdefault(r[0], []).append(Span(*r, r[6] - r[5] - children.get(r[2], 0)))
        device_ms: Dict[str, Dict[Any, float]] = {}
        for name, id, ms in list(self._device_ms):
            device_ms.setdefault(name, {})[id] = ms
        return {"spans": spans, "counters": counters, "device_ms": device_ms, "dropped": ended - len(ring),
                "since_ns": ring[0][6] if ring else 0}

    def idle_gaps(self, events) -> List[list]:
        """The device's idle gaps in a profiler's `events` (`prof.events()`),
        longest first → [[label, seconds], ...]. A gap runs between two
        unions of device activities; its label is the innermost of this
        recorder's spans (the latest started) whose trace event holds the
        gap's middle, else "other": the rule the benchmark's harness applies
        to its own spans. A user annotation (`record_function`) also puts a
        range on the device's rows, under its name: it is no device work."""
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)} | self._names
        device = sorted(((e.time_range.start, e.time_range.end) for e in events
                         if e.device_type == cuda and e.name not in annotations))
        merged: List[list] = []
        for start, end in device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        spans = [e for e in events if e.device_type == cpu and e.name in self._names]
        gaps = []
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = 0.5 * (a + b)
            holding = [s for s in spans if s.time_range.start <= mid <= s.time_range.end]
            label = max(holding, key=lambda s: s.time_range.start).name if holding else "other"
            gaps.append([label, (b - a) / 1e6])
        return sorted(gaps, key=lambda g: -g[1])


RECORDER = Recorder()


def span(name: str, id=None):
    """A span of `RECORDER` (see the module docstring)."""
    return RECORDER.span(name, id)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def gauge(name: str, n: int) -> None:
    RECORDER.gauge(name, n)


def device_counter(name: str, device) -> torch.Tensor:
    return RECORDER.device_counter(name, device)


def device_time(name: str, id, device):
    return RECORDER.device_time(name, id, device)


def snapshot() -> dict:
    return RECORDER.snapshot()


def enable(on: bool = True) -> None:
    RECORDER.enabled = bool(on)


def idle_gaps(events) -> List[list]:
    return RECORDER.idle_gaps(events)


class Trace:
    """One `torch.profiler` trace written to `log_dir` at `stop()`, with its
    ten longest idle gaps beside it. The device is synchronized at both
    ends, so the trace holds exactly the kernels launched in between."""

    def __init__(self, log_dir: Path, cuda: Optional[bool] = None) -> None:
        self.log_dir = Path(log_dir)
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self.profiler.start()

    def stop(self) -> Path:
        """Stop and write the trace and its gaps → the trace's path."""
        self._sync()
        self.profiler.stop()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}"
        path = self.log_dir / f"{stem}.pt.trace.json"
        self.profiler.export_chrome_trace(str(path))
        gaps = idle_gaps(self.profiler.events())[:10]
        (self.log_dir / f"{stem}.gaps.json").write_text(json.dumps({"idle_gaps": gaps}))
        return path
