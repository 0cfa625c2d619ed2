"""Profiling and throughput instrumentation.

Counterpart of `humanrf_tpu/utils/profiling.py` over `torch.profiler`:
`Trace` records the CPU and, when a GPU is present, its CUDA activity
between `start()` and `stop()`, and writes it into its folder as one
Chrome-trace JSON file (`<host>_<pid>.<ms>.pt.trace.json`, the name that
PyTorch's TensorBoard plugin reads; chrome://tracing and Perfetto open it
too). `trace` is the same as a context manager; `RateMeter` is a windowed
throughput meter.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Optional

import torch


class Trace:
    """One `torch.profiler` trace written to `log_dir` at `stop()`. The
    device is synchronized at both ends, so the trace holds exactly the
    kernels launched in between."""

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
        """Stop and write the trace → its path."""
        self._sync()
        self.profiler.stop()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
        self.profiler.export_chrome_trace(str(path))
        return path


@contextlib.contextmanager
def trace(log_dir: Path, enabled: bool = True):
    """Trace the body into `log_dir` (see `Trace`)."""
    if not enabled:
        yield
        return
    tracer = Trace(log_dir)
    tracer.start()
    try:
        yield
    finally:
        tracer.stop()


class RateMeter:
    """Windowed throughput meter: call .tick(n_items) per step."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._items = 0

    def tick(self, n_items: int) -> None:
        self._items += n_items

    @property
    def rate(self) -> float:
        dt = time.time() - self._t0
        return self._items / dt if dt > 0 else 0.0

    def window(self) -> float:
        """Rate since last reset, then reset."""
        r = self.rate
        self.reset()
        return r
