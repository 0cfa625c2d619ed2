"""A step as one device program: captured once as a CUDA graph, then replayed.

The port's counterpart of `jax.jit` around the JAX package's train step and
render function (`humanrf_tpu/train/pipeline.py:477,534`). Both are written
with static shapes and no host read inside (static sample budgets, the valid
count and the segment routing kept on the device), so on the card each is
captured once per input signature (the shapes, types and devices of its
tensors, and its other arguments) as a `torch.cuda.CUDAGraph`:

1. the inputs are copied into static buffers on the card; a tensor that is
   the same object at the same version as at the last call (the loader's
   cached pool snapshot, its grid ring, a render's constant columns) is not
   copied again;
2. the first call of a signature runs the eager body on a side stream, as
   PyTorch's whole-network capture asks, and returns its outputs: this is
   the call's real step, and it builds the CUDA libraries and creates every
   `.grad` and optimizer moment. The body is then captured on that stream,
   which runs nothing;
3. every later call replays the graph and returns its static outputs, which
   the next replay overwrites.

Python counters do not move on a replay, so the launches of the field
query's kernels, of AdamW's and of the plane query's
(`ops/field_interp.py::launches`, `ops/adamw.py::launches`,
`ops/kplanes.py::launches`) counted while capturing are taken back and added
per replay: the counts are those of the eager steps. A capture that
fails raises, with the failing op's error; nothing falls back to the eager
body. A call whose tensors are all on the CPU runs the body eagerly: CPUs
have no graphs.

A graph reads the model's parameters where they were at capture: weights
are loaded in place (`load_state_dict`), never rebound.

The recorder (`utils/profiling.py`) sees each call as `graph.call`, id
`(name, call number)`, with `graph.capture` (a signature's first call),
`graph.copy_inputs` and `graph.replay`, and times each replay on the device
with a CUDA event pair (`graph.device_ms`, same id). It counts
`graph.captures`, `graph.input_copies`, `graph.input_copies_skipped` and
`graph.input_bytes`. The spans stay outside the captured body: Python does
not run on a replay.

A part of the body inside `timed(name)` is timed on the device per replay,
under `name` and the call's id. A pair of events recorded inside a graph
holds only its latest replay's times, and a replay's cannot be read before
the next is launched without waiting for the device; so the capture is cut
before and after the part, into graphs that share one memory pool and
replay back to back, and the part's graph replays inside a pair of events
of its own, resolved like `graph.device_ms`'s.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from humanrf_torch.ops import adamw as adamw_kernels
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import kplanes as kplanes_kernels
from humanrf_torch.utils import profiling

# The launch counters that a replay adds to (see the module docstring).
COUNTERS = (fli.launches, adamw_kernels.launches, kplanes_kernels.launches)


# The capture under way on this thread, for `timed`.
_active = threading.local()


class _Capture:
    """The graphs one capture of a body is cut into, in order: (the name a
    part is timed under, or None; its graph), all in the first one's pool."""

    def __init__(self):
        self.parts: List[Tuple[Optional[str], torch.cuda.CUDAGraph]] = []

    def begin(self, name: Optional[str]) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.parts[0][1].pool() if self.parts else None)
        self.parts.append((name, graph))

    def end(self) -> None:
        self.parts[-1][1].capture_end()

    def cut(self, name: Optional[str]) -> None:
        self.end()
        self.begin(name)


@contextlib.contextmanager
def timed(name: str):
    """Time the device work of the block, inside a step's body, per replay
    under `name` (see the module docstring). Outside a capture (the CPU, a
    signature's first call, the eager multi-rank steps) it does nothing."""
    capture = getattr(_active, "capture", None)
    if capture is None:
        yield
        return
    capture.cut(name)
    yield
    capture.cut(None)


class _Captured:
    """One input signature's graphs: static inputs, outputs and launches."""

    def __init__(self, static: List[Optional[torch.Tensor]]):
        self.static = static
        self.seen: List = [None] * len(static)  # (tensor, version) last copied per leaf
        self.graphs: List[Tuple[Optional[str], torch.cuda.CUDAGraph]] = []  # `_Capture.parts`
        self.out = None
        self.launches: List[Dict[str, int]] = []  # per counter of COUNTERS

    def copy_inputs(self, leaves) -> None:
        copies = skipped = nbytes = 0
        for i, (leaf, buf) in enumerate(zip(leaves, self.static)):
            if buf is None:
                continue
            seen = self.seen[i]
            if seen is not None and seen[0] is leaf and seen[1] == leaf._version:
                skipped += 1
                continue
            buf.copy_(leaf, non_blocking=True)
            self.seen[i] = (leaf, leaf._version)
            copies += 1
            nbytes += buf.nbytes
        profiling.count("graph.input_copies", copies)
        profiling.count("graph.input_copies_skipped", skipped)
        profiling.count("graph.input_bytes", nbytes)


class GraphedStep:
    """`body(*args, **kwargs)` replayed as a CUDA graph per input signature
    (see the module docstring); `name` goes into a failed capture's error."""

    def __init__(self, name: str, body: Callable):
        self.name = name
        self.body = body
        self._graphs: Dict[str, _Captured] = {}
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        call = (self.name, self.calls)
        with profiling.span("graph.call", call):
            return self._call(call, args, kwargs)

    def _call(self, call, args, kwargs):
        leaves, spec = tree_flatten((args, kwargs))
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        device = next((t.device for t in tensors if t.device.type == "cuda"), None)
        if device is None:
            return self.body(*args, **kwargs)  # the CPU: eager
        key = repr((spec, [(tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor) else t
                           for t in leaves]))
        entry = self._graphs.get(key)
        if entry is None:
            with profiling.span("graph.capture"):
                entry, out = self._warm_up_and_capture(leaves, spec, device)
            profiling.count("graph.captures")
            self._graphs[key] = entry
            return out
        with profiling.span("graph.copy_inputs"):
            entry.copy_inputs(leaves)
        with profiling.span("graph.replay"), profiling.device_time("graph.device_ms", call, device):
            for name, graph in entry.graphs:
                if name is None:
                    graph.replay()
                else:
                    with profiling.device_time(name, call, device):
                        graph.replay()
        for counter, launched in zip(COUNTERS, entry.launches):
            for name, n in launched.items():
                counter[name] += n
        return entry.out

    def _warm_up_and_capture(self, leaves, spec, device):
        """→ (the signature's graph, the eager body's outputs for this call)."""
        entry = _Captured([torch.empty(t.shape, dtype=t.dtype, device=device) if isinstance(t, torch.Tensor) else None
                           for t in leaves])
        entry.copy_inputs(leaves)
        args, kwargs = tree_unflatten([s if s is not None else leaf for s, leaf in zip(entry.static, leaves)], spec)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = self.body(*args, **kwargs)  # this call's step
        capture = _Capture()
        before = [dict(counter) for counter in COUNTERS]
        torch.cuda.synchronize(device)  # as `torch.cuda.graph` readies a capture
        gc.collect()
        torch.cuda.empty_cache()
        _active.capture = capture
        try:
            with torch.cuda.stream(stream):
                capture.begin(None)
                try:
                    entry.out = self.body(*args, **kwargs)
                except BaseException:
                    with contextlib.suppress(Exception):
                        capture.end()
                    raise
                capture.end()
        except Exception as e:
            raise RuntimeError(f"capturing {self.name} as a CUDA graph failed (there is no eager fallback): {e}") from e
        finally:
            _active.capture = None
        entry.launches = [{k: counter[k] - was[k] for k in was} for counter, was in zip(COUNTERS, before)]
        for counter, was in zip(COUNTERS, before):
            counter.update(was)  # the capture launched nothing
        torch.cuda.current_stream(device).wait_stream(stream)
        entry.graphs = capture.parts
        return entry, out
